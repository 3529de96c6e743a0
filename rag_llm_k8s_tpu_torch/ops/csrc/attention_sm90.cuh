// Attention routines for Hopper (sm_90a) over a K/V addressing policy: the
// chunk routine (S queries per row, wgmma tiles in registers), its form over
// an int8 payload, its warp-specialized form for long rows (TMA producer
// warp, two consumer warpgroups, one split) and the decode routine (one
// query per row, split-KV on mma.sync) and its form over an int8 payload,
// with the pass that merges split-KV partials. attention_sm90.cu runs chunk
// and decode over one layer of the dense bf16 cache, attention.cu the chunk
// and warp-specialized routines over fresh K/V, paged_attention.cu the chunk
// and decode routines over the paged arena, attention_q8.cu the int8 chunk
// and decode routines over the int8 cache and arena. The policy interface
// (the int8 routines' is in the int8 chunk routine's section):
//
//   struct KV {
//     int start(int b) const;    // first valid key position of row b
//     int len(int b) const;      // valid key frontier (exclusive)
//     int offset(int b) const;   // logical position of row b's query 0
//     const bf16* k_row(int b, int kvh, int kp) const;  // hd contiguous,
//     const bf16* v_row(int b, int kvh, int kp) const;  // 16-byte aligned
//   };
//
// The decode routines address a 16-key tile from its first key: keys kp ..
// kp + 15 from a multiple of 16 must be contiguous rows (a dense cache; an
// arena whose block size is a multiple of 16).
//
// Semantics kept from the TPU kernels: fp32 running max, sum and accumulator;
// the key window [start, len) per batch row plus (offset) causality
// t_k <= offset + t; K/V rows outside the window enter shared memory as
// zeros (cp.async with a source size of 0 never reads them: slots past a
// frontier may hold NaN, and 0 * NaN = NaN); p is rounded to bf16 before the
// PV product; a query row with no visible key writes 0; query head h reads
// kv head h / G directly. The running max lives in the log2 domain (scores
// scaled by hd^-0.5 * log2 e), so each weight is one FFMA and one ex2.
//
// Split-KV. A (row tile, batch row, kv head) block may cover only a split of
// its visible keys: the range [lo, hi) (hi clipped by causality at the
// tile's last row) is cut into splits of split_keys from lo rounded down to
// the key tile, so every split is tile-aligned and only the last is short.
// A split block writes its partial (m, l, acc) in fp32 for every row of its
// tile (m = NEG_INF, l = 0, acc = 0 for a row that sees none of its keys),
// and merge_kernel combines the n_s splits of each row as
// sum(acc_s 2^(m_s - m)) / sum(l_s 2^(m_s - m)). With one split the block
// normalizes and writes the output itself and no merge runs.

#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is reached through the runtime: no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace attn_sm90 {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;

struct Params {
  const bf16* q;
  long long q_sb, q_st, q_sh;  // q[b, t, h, :] at b*q_sb + t*q_st + h*q_sh
  bf16* o;                     // [B, S, H, hd] contiguous
  float* part_m;               // [B*K, n_splits, S*G]; null: no split, o is
  float* part_l;               //   written directly
  float* part_acc;             // [B*K, n_splits, S*G, hd]
  int S, H, K, G, causal;
  int split_keys, n_splits;
  float scale_log2;            // hd^-0.5 * log2(e)
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; a row outside the window (in = false) is
// zero-filled and its source never read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// makes this thread's completed shared-memory writes visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_zero16(uint32_t a) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" :: "r"(a), "r"(0) : "memory");
}

// mbarriers in shared memory, TMA tile loads that complete on them, a named
// barrier (a subset of the block's threads) and register reallocation (warp
// specialization)
__device__ __forceinline__ void mbar_init(uint32_t a, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(a), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t a) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(a) : "memory");
}
// arrives and adds `bytes` to the phase's expected transaction count
__device__ __forceinline__ void mbar_expect_tx(uint32_t a, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(a), "r"(bytes) : "memory");
}
// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t a, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}
// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory at dst, completing on the mbarrier at bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps registers that an asynchronous wgmma reads or writes live, and
// unread, until this point: call it after the wgmma_wait that retires it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (all >> 4), layout type 1 (128B swizzle).
// Every 8-row group of such a tile starts on a 1024-byte boundary.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16
         | static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32
         | static_cast<uint64_t>(1) << 62;
}

// A tile of ROWS rows of hd bf16 values is stored as hd / 64 column blocks
// of ROWS x 128 bytes, 16-byte chunk c of row r at chunk (c ^ r) % 8 of its
// 128-byte line: the layout of a TMA 128B-swizzled box, which wgmma reads
// through make_desc and ldmatrix reads without bank conflicts.
template <int ROWS>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 2^x (MUFU; relative error ~2^-22, flushes to 0 far below the range)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// wgmma m64nNk16, bf16 x bf16 -> fp32. ss: A and B from shared memory, both
// K-major; scale_d = 0 overwrites d. rs: A from registers (the m16n8k16
// fragment layout, one 16-row slice per warp), B MN-major (transposed),
// accumulating into d.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_m64n128k16(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128k16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// split plan
// ---------------------------------------------------------------------------

// The visible keys [lo, hi) of a row tile, cut into n_s splits of split_keys
// from lo_a (lo rounded down to the key tile)
struct Span {
  int lo, hi, lo_a, n_s;
};

template <class KV>
__device__ __forceinline__ Span tile_span(const KV& kv, const Params& p, int b, int last_row, int tile) {
  Span sp;
  sp.lo = max(kv.start(b), 0);
  sp.hi = kv.len(b);
  if (p.causal) sp.hi = min(sp.hi, kv.offset(b) + last_row / p.G + 1);
  sp.lo_a = (sp.lo / tile) * tile;
  sp.n_s = sp.hi > sp.lo ? (sp.hi - sp.lo_a + p.split_keys - 1) / p.split_keys : 0;
  return sp;
}

// ---------------------------------------------------------------------------
// one warpgroup's 64 query rows on wgmma fragments
// ---------------------------------------------------------------------------
//
// The m64nN accumulator of a warpgroup gives each thread two rows, a =
// 16 * warp + lane / 4 and a + 8, and in each 8-column group j the columns
// 8j + kc, 8j + kc + 1 (kc = 2 * (lane % 4)): x[4j + e] is row a, x[4j + 2 + e]
// row a + 8. A row lives in the 4 threads of a quad.

struct Rows {
  float m_a = NEG_INF, m_b = NEG_INF;  // running max, log2 domain
  float l_a = 0.f, l_b = 0.f;          // running sum (this thread's columns)
  int qpos_a, qpos_b;                  // the rows' query positions
};

// Online softmax of the N-key tile at k0 on the score fragments s: leaves
// the weights in s and the rescale factors of O in al_a, al_b. A tile wholly
// inside the window and below the diagonal needs no mask (MASKED = false);
// otherwise an invisible key's raw score becomes NEG_INF and its weight a
// select to 0 (the raw score of a zero-filled key row is 0, never NaN). The
// mask is a template parameter so the unmasked loop is straight-line code
// whose ex2 latencies the compiler can interleave.
template <int N, bool MASKED>
__device__ __forceinline__ void online_softmax_tile(float (&s)[N / 2], Rows& r, int k0, int kc, int lo,
                                                    int len, int causal, float scale_log2, float& al_a,
                                                    float& al_b) {
  float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (MASKED) {
        const int kp = k0 + 8 * j + kc + e;
        const bool in = kp >= lo && kp < len;
        if (!in || (causal && kp > r.qpos_a)) s[4 * j + e] = NEG_INF;
        if (!in || (causal && kp > r.qpos_b)) s[4 * j + 2 + e] = NEG_INF;
      }
      mx_a = fmaxf(mx_a, s[4 * j + e]);
      mx_b = fmaxf(mx_b, s[4 * j + 2 + e]);
    }
  }
  mx_a = quad_max(mx_a);
  mx_b = quad_max(mx_b);
  const float mn_a = fmaxf(r.m_a, mx_a == NEG_INF ? NEG_INF : mx_a * scale_log2);
  const float mn_b = fmaxf(r.m_b, mx_b == NEG_INF ? NEG_INF : mx_b * scale_log2);
  al_a = ex2(r.m_a - mn_a);
  al_b = ex2(r.m_b - mn_b);
  r.m_a = mn_a;
  r.m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float xa = s[4 * j + e], xb = s[4 * j + 2 + e];
      float pa = ex2(fmaf(xa, scale_log2, -mn_a)), pb = ex2(fmaf(xb, scale_log2, -mn_b));
      if constexpr (MASKED) {
        pa = xa == NEG_INF ? 0.f : pa;
        pb = xb == NEG_INF ? 0.f : pb;
      }
      s[4 * j + e] = pa;
      s[4 * j + 2 + e] = pb;
      sum_a += pa;
      sum_b += pb;
    }
  }
  r.l_a = r.l_a * al_a + sum_a;
  r.l_b = r.l_b * al_b + sum_b;
}
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2], Rows& r, int k0, int kc, bool masked,
                                               int lo, int len, int causal, float scale_log2,
                                               float& al_a, float& al_b) {
  if (masked) online_softmax_tile<N, true>(s, r, k0, kc, lo, len, causal, scale_log2, al_a, al_b);
  else online_softmax_tile<N, false>(s, r, k0, kc, lo, len, causal, scale_log2, al_a, al_b);
}

// Rescales O to the new running max and rounds P to bf16 as the A operand
// of the PV product (keys 16kk .. 16kk + 15 are the groups j = 2kk, 2kk + 1).
template <int HD, int N>
__device__ __forceinline__ void take_p(float (&o)[HD / 2], const float (&s)[N / 2], uint32_t (&pf)[N / 16][4],
                                       float al_a, float al_b) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[4 * j] *= al_a;
    o[4 * j + 1] *= al_a;
    o[4 * j + 2] *= al_b;
    o[4 * j + 3] *= al_b;
  }
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    pf[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// S = Q K^T over hd in steps of 16 (Q rows q_rows * 128 bytes per column
// block, this warpgroup's 64 at q_off; K a tile of N rows), then O += P V
// over the tile's N keys (V read transposed).
template <int HD, int N>
__device__ __forceinline__ void mma_qk(float (&s)[N / 2], uint32_t q_s, int q_rows, int q_off, uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t koff = (kk % 4) * 32;  // 16 of the line's 64 columns
    const uint64_t da = make_desc(q_s + (kk / 4) * (q_rows * 128) + q_off + koff, 16, 1024);
    const uint64_t db = make_desc(ks + (kk / 4) * (N * 128) + koff, 16, 1024);
    if constexpr (N == 128) wgmma_ss_m64n128k16(s, da, db, kk > 0);
    else wgmma_ss_m64n64k16(s, da, db, kk > 0);
  }
}
template <int HD, int N>
__device__ __forceinline__ void mma_pv(float (&o)[HD / 2], const uint32_t (&pf)[N / 16][4], uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint64_t dv = make_desc(vs + kk * 16 * 128, N * 128, 1024);
    if constexpr (HD == 128) wgmma_rs_m64n128k16(o, pf[kk], dv);
    else wgmma_rs_m64n64k16(o, pf[kk], dv);
  }
}

// Writes this thread's two rows (row_a, row_a + 8 of the n_rows query rows
// of (b, kvh)): normalized bf16 into o, or with split partials this split's
// (m, l, acc) in fp32.
template <int HD>
__device__ __forceinline__ void store_rows(const Params& p, const float (&o)[HD / 2], Rows& r, int row_a,
                                           int n_rows, int b, int kvh, int split, int lane) {
  const int kc = 2 * (lane % 4), bk = b * p.K + kvh;
  r.l_a = quad_sum(r.l_a);
  r.l_b = quad_sum(r.l_b);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = row_a + 8 * half;
    if (rr >= n_rows) continue;
    const float m = half ? r.m_b : r.m_a, l = half ? r.l_b : r.l_a;
    if (p.part_m == nullptr) {
      const int t = rr / p.G, h = kvh * p.G + rr % p.G;
      const float inv = 1.f / fmaxf(l, 1e-30f);
      bf16* orow = p.o + ((long long)(b * p.S + t) * p.H + h) * HD + kc;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
    } else {
      const long long ix = ((long long)bk * p.n_splits + split) * n_rows + rr;
      if (lane % 4 == 0) {
        p.part_m[ix] = m;
        p.part_l[ix] = l;
      }
      float* arow = p.part_acc + ix * HD + kc;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(arow + 8 * j) = make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// chunk routine: S queries per row, wgmma
// ---------------------------------------------------------------------------
//
// One block of WG warpgroups per (tile of 64 * WG query rows, batch row, kv
// head, split), where a query row is a (position, head-in-group) pair: a K/V
// tile loaded once serves all G heads of its group and both warpgroups.
// Each warpgroup owns 64 rows: S = Q K^T is one wgmma m64n64 chain with Q
// and K from shared memory, the softmax runs on the accumulator fragments,
// P is rounded to bf16 into the A-operand registers of O += P V (wgmma
// m64n{hd}, V transposed from shared memory), and O stays in registers. K/V
// tiles of 64 keys stream through a cp.async ring of STAGES; the copy of
// tile i + STAGES - 1 is in flight while tile i is multiplied. Key tiles
// wholly outside the window or above the causal diagonal are never visited;
// blocks are scheduled latest row tile first, so the longest causal rows
// start first. The addressing policy needs only k_row / v_row, so a key tile
// may gather its rows from anywhere (the paged arena's blocks).

constexpr int CBN = 64;  // keys per tile

template <int HD, int WG, int STAGES>
struct ChunkCfg {
  static constexpr int BM = 64 * WG;
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = CBN * HD * 2;  // one K or V tile
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;  // + alignment
};

template <int HD, int WG, int STAGES, class KV>
__global__ void __launch_bounds__(WG * 128, 1) chunk_kernel(Params p, KV kv) {
  using C = ChunkCfg<HD, WG, STAGES>;
  constexpr int NT = WG * 128;
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + C::Q_BYTES;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int n_rows = p.S * p.G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * C::BM;
  const int bk = blockIdx.y, b = bk / p.K, kvh = bk % p.K, split = blockIdx.z;
  const Span sp = tile_span(kv, p, b, min(r0 + C::BM, n_rows) - 1, CBN);
  if (split >= max(sp.n_s, 1)) return;
  const int lo = sp.lo, len = kv.len(b), q_offset = kv.offset(b);
  const int k_begin = sp.lo_a + split * p.split_keys;
  const int k_end = min(sp.hi, k_begin + p.split_keys);
  const int n_kt = k_end > k_begin ? (k_end - k_begin + CBN - 1) / CBN : 0;

  for (int x = tid; x < C::BM * CH; x += NT) {
    const int r = x / CH, c = x % CH, rr = r0 + r;
    const bool in = rr < n_rows;
    const int t = in ? rr / p.G : 0, h = kvh * p.G + (in ? rr % p.G : 0);
    cp_async16(q_s + tile_off<C::BM>(r, c), p.q + b * p.q_sb + t * p.q_st + h * p.q_sh + c * 8, in);
  }
  auto stage = [&](int i) { return kv_s + (i % STAGES) * 2 * C::KV_BYTES; };  // K, then V
  // each thread copies chunk lc of rows lr, lr + NT / CH, ...
  const int lc = tid % CH, lr = tid / CH;
  auto load_kv = [&](int i) {
    const int k0 = k_begin + i * CBN;
    const uint32_t ks = stage(i), vs = ks + C::KV_BYTES;
#pragma unroll
    for (int n = lr; n < CBN; n += NT / CH) {
      const int kp = k0 + n;
      const bool in = kp >= lo && kp < len;
      const int kr = in ? kp : lo;
      const uint32_t off = tile_off<CBN>(n, lc);
      cp_async16(ks + off, kv.k_row(b, kvh, kr) + lc * 8, in);
      cp_async16(vs + off, kv.v_row(b, kvh, kr) + lc * 8, in);
    }
  };
  constexpr int PF = STAGES - 1;  // tiles in flight ahead of the one multiplied
#pragma unroll
  for (int i = 0; i < PF; ++i) {  // Q travels with tile 0
    if (i < n_kt) load_kv(i);
    cp_async_commit();
  }

  const int wr0 = r0 + wg * 64;
  const bool wg_live = wr0 < n_rows;
  const int row_a = wr0 + warp * 16 + lane / 4;
  Rows rs;
  rs.qpos_a = q_offset + row_a / p.G;
  rs.qpos_b = q_offset + (row_a + 8) / p.G;
  const int wg_first = q_offset + wr0 / p.G;
  const int wg_last = q_offset + (min(wr0 + 64, n_rows) - 1) / p.G;
  const int kc = 2 * (lane % 4);

  float o[HD / 2], s[CBN / 2];
  uint32_t pf[CBN / 16][4];  // P of a tile as the A operand of its PV product
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < CBN / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < CBN / 16; ++i) pf[i][0] = pf[i][1] = pf[i][2] = pf[i][3] = 0u;

  for (int i = 0; i < n_kt; ++i) {
    cp_async_wait<PF - 1>();
    fence_proxy_async();
    __syncthreads();  // tile i has landed; every thread is done with tile i - 1
    if (i + PF < n_kt) load_kv(i + PF);
    cp_async_commit();
    const int k0 = k_begin + i * CBN;
    if (!wg_live || (p.causal && k0 > wg_last)) continue;  // nothing this warpgroup sees
    const bool masked = k0 < lo || k0 + CBN > len || (p.causal && k0 + CBN - 1 > wg_first);
    float al_a, al_b;
    wgmma_fence();
    mma_qk<HD, CBN>(s, q_s, C::BM, wg * 8192, stage(i));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    online_softmax<CBN>(s, rs, k0, kc, masked, lo, len, p.causal, p.scale_log2, al_a, al_b);
    take_p<HD, CBN>(o, s, pf, al_a, al_b);
    wgmma_fence();
    mma_pv<HD, CBN>(o, pf, stage(i) + C::KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);
  }
  cp_async_wait<0>();
  if (wg_live) store_rows<HD>(p, o, rs, row_a, n_rows, b, kvh, split, lane);
}

// ---------------------------------------------------------------------------
// chunk routine over an int8 payload
// ---------------------------------------------------------------------------
//
// chunk_kernel over a cache whose K and V rows are int8 with one fp32 scale
// per (key, kv head). The policy's rows are int8, and it adds the scales:
//
//   const int8_t* k_row(int b, int kvh, int kp) const;    // hd bytes, 16-byte
//   const int8_t* v_row(int b, int kvh, int kp) const;    //   aligned
//   const float* k_scales(int b, int kvh, int kp) const;  // key kp's scale; the
//   const float* v_scales(int b, int kvh, int kp) const;  //   4 keys from a multiple
//                                                         //   of 4 are contiguous
//
// The function of the TPU q8 kernels: K and V are converted exactly to bf16
// (|x| <= 127), each score column is multiplied by its k-scale before the
// running max, and the A operand of the PV product is bf16(p * v-scale) while
// the running sum takes p. A scale outside the window (it may be NaN) is set
// to 0 as its tile is converted, before it multiplies anything. Neither scale
// is folded into the payload, which would round differently.
//
// cp.async carries each tile's int8 K and V (64 rows of hd bytes, rows
// outside the window zero-filled) and its 64 k- and v-scales (16-byte pieces,
// read whole when a piece holds a key of the window: a piece may straddle its
// edge) into a ring of STAGES. wgmma has no bf16 x int8 form and reads B from
// shared memory, so the block's threads widen a landed tile into the bf16
// 128-byte-swizzled layout that mma_qk and mma_pv read, with the
// window-selected scales beside it, in one of NB buffers. With two, tile
// i + 1's K is converted while the tensor cores multiply tile i's S = Q K^T
// and its V while they multiply O += P V. With one (a block of one
// warpgroup: two blocks then fit an SM), a tile is converted between two
// barriers before its products.

// four int8 (one word) to four bf16 (two words, in order), exactly: byte x,
// offset to x + 128, becomes the low mantissa byte of the fp32 2^23, the
// offset is subtracted, and the upper half of the fp32 is the bf16 (an
// integer of magnitude <= 128 has at most 8 significant bits)
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Multiplies this thread's columns of an N-key tile (both rows) by their
// per-key factors f[col] in shared memory.
template <int N>
__device__ __forceinline__ void scale_cols(float (&s)[N / 2], const float* f, int kc) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 x = *reinterpret_cast<const float2*>(f + 8 * j + kc);
    s[4 * j] *= x.x;
    s[4 * j + 1] *= x.y;
    s[4 * j + 2] *= x.x;
    s[4 * j + 3] *= x.y;
  }
}

template <int HD, int WG, int STAGES, int NB>
struct ChunkQ8Cfg {
  static constexpr int BM = 64 * WG;
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int BF_BYTES = CBN * HD * 2;  // one converted K or V tile
  static constexpr int SC_BYTES = CBN * 4;       // one tile's k- or v-scales
  static constexpr int I8_BYTES = CBN * HD;      // one int8 K or V tile
  static constexpr int STAGE_BYTES = 2 * I8_BYTES + 2 * SC_BYTES;
  // Q, NB converted K/V pairs, their scales, then the int8 ring
  static constexpr int BF_OFF = Q_BYTES;
  static constexpr int SC_OFF = BF_OFF + NB * 2 * BF_BYTES;
  static constexpr int RING_OFF = SC_OFF + NB * 2 * SC_BYTES;
  static constexpr int SMEM = RING_OFF + STAGES * STAGE_BYTES + 1024;  // + alignment
};

template <int HD, int WG, int STAGES, int NB, class KV>
__global__ void __launch_bounds__(WG * 128, 1) chunk_q8_kernel(Params p, KV kv) {
  using C = ChunkQ8Cfg<HD, WG, STAGES, NB>;
  constexpr int NT = WG * 128;
  constexpr int CH = HD / 8;    // 16-byte chunks of a bf16 row
  constexpr int CH8 = HD / 16;  // 16-byte chunks of an int8 row
  constexpr int CV = 2 * CBN * CH8 / NT;  // int8 chunks each thread widens per tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (q_s - smem_u32(smem_raw));  // q_s as a pointer

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int n_rows = p.S * p.G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * C::BM;
  const int bk = blockIdx.y, b = bk / p.K, kvh = bk % p.K, split = blockIdx.z;
  const Span sp = tile_span(kv, p, b, min(r0 + C::BM, n_rows) - 1, CBN);
  if (split >= max(sp.n_s, 1)) return;
  const int lo = sp.lo, len = kv.len(b), q_offset = kv.offset(b);
  const int k_begin = sp.lo_a + split * p.split_keys;
  const int k_end = min(sp.hi, k_begin + p.split_keys);
  const int n_kt = k_end > k_begin ? (k_end - k_begin + CBN - 1) / CBN : 0;

  for (int x = tid; x < C::BM * CH; x += NT) {
    const int r = x / CH, c = x % CH, rr = r0 + r;
    const bool in = rr < n_rows;
    const int t = in ? rr / p.G : 0, h = kvh * p.G + (in ? rr % p.G : 0);
    cp_async16(q_s + tile_off<C::BM>(r, c), p.q + b * p.q_sb + t * p.q_st + h * p.q_sh + c * 8, in);
  }
  auto stage = [&](int i) { return C::RING_OFF + (i % STAGES) * C::STAGE_BYTES; };  // K, V, k-, v-scales
  // each thread copies chunk lc of int8 rows lr, lr + NT / CH8, ...; warp 0
  // also copies the 2 x 16 scale pieces
  const int lc = tid % CH8, lr = tid / CH8;
  auto load_kv = [&](int i) {
    const int k0 = k_begin + i * CBN;
    const uint32_t ks = q_s + stage(i), vs = ks + C::I8_BYTES;
#pragma unroll
    for (int n = lr; n < CBN; n += NT / CH8) {
      const int kp = k0 + n;
      const bool in = kp >= lo && kp < len;
      const int kr = in ? kp : lo;
      cp_async16(ks + n * HD + lc * 16, kv.k_row(b, kvh, kr) + lc * 16, in);
      cp_async16(vs + n * HD + lc * 16, kv.v_row(b, kvh, kr) + lc * 16, in);
    }
    if (tid < 2 * CBN / 4) {
      const int n = (tid % (CBN / 4)) * 4, kp = k0 + n;
      const bool in = kp + 3 >= lo && kp < len;
      const int kr = in ? kp : lo & ~3;
      const float* src = tid < CBN / 4 ? kv.k_scales(b, kvh, kr) : kv.v_scales(b, kvh, kr);
      cp_async16(vs + C::I8_BYTES + (tid / (CBN / 4)) * C::SC_BYTES + n * 4, src, in);
    }
  };
  // widens tile i's int8 K (part 0; with the tile's scales, 0 outside the
  // window) or V (part 1) into bf16 buffer c
  auto convert = [&](int i, int c, int part) {
    const int k0 = k_begin + i * CBN;
    const unsigned char* src = sm + stage(i);
    unsigned char* dst = sm + C::BF_OFF + c * 2 * C::BF_BYTES;
#pragma unroll
    for (int j = part * CV / 2; j < (part + 1) * CV / 2; ++j) {
      const int x = tid + j * NT, half = x / (CBN * CH8), n = (x / CH8) % CBN, c8 = x % CH8;  // half 0: K, 1: V
      const uint4 w = *reinterpret_cast<const uint4*>(src + half * C::I8_BYTES + n * HD + c8 * 16);
      uint4 a, z;  // bf16 chunks 2 c8 and 2 c8 + 1 of row n
      i8x4_to_bf16x4(w.x, a.x, a.y);
      i8x4_to_bf16x4(w.y, a.z, a.w);
      i8x4_to_bf16x4(w.z, z.x, z.y);
      i8x4_to_bf16x4(w.w, z.z, z.w);
      // an odd column block stores its second chunk first: the 8 threads of
      // a 16-byte store phase then hit 8 different bank groups
      const int sw = (c8 >> 2) & 1;
      unsigned char* t = dst + half * C::BF_BYTES;
      *reinterpret_cast<uint4*>(t + tile_off<CBN>(n, 2 * c8 + sw)) = sw ? z : a;
      *reinterpret_cast<uint4*>(t + tile_off<CBN>(n, 2 * c8 + 1 - sw)) = sw ? a : z;
    }
    if (part == 0) {  // every thread writes one scale (two threads the same one when NT = 256)
      const int x = tid % (2 * CBN), kp = k0 + x % CBN;
      const float sc = reinterpret_cast<const float*>(src + 2 * C::I8_BYTES)[x];
      reinterpret_cast<float*>(sm + C::SC_OFF + c * 2 * C::SC_BYTES)[x] = kp >= lo && kp < len ? sc : 0.f;
    }
  };
  // tiles 0 .. AHEAD - 1 in flight (Q travels with tile 0); iteration i
  // issues tile i + AHEAD into the stage of the last tile converted
  constexpr int AHEAD = STAGES + NB - 2;
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) {
    if (i < n_kt) load_kv(i);
    cp_async_commit();
  }

  const int wr0 = r0 + wg * 64;
  const bool wg_live = wr0 < n_rows;
  const int row_a = wr0 + warp * 16 + lane / 4;
  Rows rs;
  rs.qpos_a = q_offset + row_a / p.G;
  rs.qpos_b = q_offset + (row_a + 8) / p.G;
  const int wg_first = q_offset + wr0 / p.G;
  const int kc = 2 * (lane % 4);

  float o[HD / 2], s[CBN / 2];
  uint32_t pf[CBN / 16][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < CBN / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < CBN / 16; ++i) pf[i][0] = pf[i][1] = pf[i][2] = pf[i][3] = 0u;

  if (NB == 2 && n_kt > 0) {
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // tile 0 has landed
    convert(0, 0, 0);
    convert(0, 0, 1);
  }
  for (int i = 0; i < n_kt; ++i) {
    // NB = 2: tile i is converted and tile i + 1 has landed; NB = 1: tile i
    // has landed. Either way every product of tile i - 1 is done.
    cp_async_wait<STAGES - 2>();
    if constexpr (NB == 2) fence_proxy_async();
    __syncthreads();
    if (i + AHEAD < n_kt) load_kv(i + AHEAD);
    cp_async_commit();
    if constexpr (NB == 1) {
      convert(i, 0, 0);
      convert(i, 0, 1);
      fence_proxy_async();
      __syncthreads();
    }
    // No branch may stand between a wgmma and its wait (ptxas would then
    // serialize every wgmma), so a warpgroup multiplies every tile: a tile
    // wholly above its diagonal, or a warpgroup past the last row, is masked
    // to no effect. With NB = 2 the conversion of tile i + 1 runs during the
    // products; after the last tile it widens whatever that stage holds into
    // a buffer no product reads.
    const int k0 = k_begin + i * CBN, c = NB == 2 ? i & 1 : 0;
    const uint32_t kb = q_s + C::BF_OFF + c * 2 * C::BF_BYTES;
    const float* ksc = reinterpret_cast<const float*>(sm + C::SC_OFF + c * 2 * C::SC_BYTES);
    const bool masked = k0 < lo || k0 + CBN > len || (p.causal && k0 + CBN - 1 > wg_first);
    float al_a, al_b;
    wgmma_fence();
    mma_qk<HD, CBN>(s, q_s, C::BM, wg * 8192, kb);
    wgmma_commit();
    if constexpr (NB == 2) convert(i + 1, c ^ 1, 0);
    wgmma_wait<0>();
    fence_regs(s);
    scale_cols<CBN>(s, ksc, kc);
    online_softmax<CBN>(s, rs, k0, kc, masked, lo, len, p.causal, p.scale_log2, al_a, al_b);
    scale_cols<CBN>(s, ksc + CBN, kc);  // p * v-scale; the sum took p
    take_p<HD, CBN>(o, s, pf, al_a, al_b);
    wgmma_fence();
    mma_pv<HD, CBN>(o, pf, kb + C::BF_BYTES);
    wgmma_commit();
    if constexpr (NB == 2) convert(i + 1, c ^ 1, 1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);
  }
  cp_async_wait<0>();
  if (wg_live) store_rows<HD>(p, o, rs, row_a, n_rows, b, kvh, split, lane);
}

// ---------------------------------------------------------------------------
// warp-specialized chunk routine: a TMA producer warp and two consumer
// warpgroups (one split)
// ---------------------------------------------------------------------------
//
// For long rows that take one split (the causal Llama prefill, the bge-m3
// encoder), laid out as FlashAttention-3 lays out its forward pass. One block
// of three warpgroups per (tile of 128 query rows, batch row, kv head):
//
// - Warpgroup 0 gives its registers away (setmaxnreg 40), and one of its
//   threads issues every copy as a TMA box load: Q once, then K and V tiles
//   of WBN keys into a ring of ST stages. Each stage has a full mbarrier
//   (completed by the copies' byte count) and an empty one (completed when
//   the 256 consumer threads are done with the stage).
// - Warpgroups 1 and 2 raise their budget (setmaxnreg 232) and each owns 64
//   rows, with S, P and O in registers as in chunk_kernel. They never meet
//   at a barrier: each waits only for its tile's copies, so one warpgroup's
//   softmax runs while the other's products hold the tensor cores. (Making
//   them take turns with named barriers, around S alone or around the pair
//   PV_i-1 + S_i, and overlapping a warpgroup's softmax with its own PV
//   product, all measured slower on the H100; PERF.md §6.)
//
// The tensor maps cover whole tensors, so TMA fills rows past a tensor's end
// with zeros. Rows inside the tensor but outside the row's window
// [start, len) may hold NaN: each consumer warpgroup zeroes them in a tile
// the window edge cuts before its products read the tile (both warpgroups
// write the same zeros). Heaviest row tile first, as chunk_kernel.
//
// The policy adds to start / len / offset the outer coordinates of a key
// row in the K/V tensor maps:  int3 tma_row(int b, int kvh, int kp) const;
// Q's map is [B, S, H, hd]: a row tile is BM / G positions x G heads.

constexpr int WBN = 128;  // keys per tile
constexpr int WS_THREADS = 384;
constexpr int WS_PRODUCER_REGS = 40, WS_CONSUMER_REGS = 232;  // 40 + 2 x 232 = 3 x 168

template <int HD, int ST>
struct WsCfg {
  static constexpr int BM = 128;
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = WBN * HD * 2;  // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + ST * 2 * KV_BYTES;  // q_full, full[ST], empty[ST]
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * ST) + 1024;  // + alignment
};

template <int HD, int ST, class KV>
__global__ void __launch_bounds__(WS_THREADS, 1)
    ws_kernel(Params p, KV kv, const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v) {
  using C = WsCfg<HD, ST>;
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + C::Q_BYTES;
  const uint32_t q_full = q_s + C::BAR_OFF;
  auto full = [&](int i) { return q_full + 8 * (1 + i % ST); };
  auto empty = [&](int i) { return q_full + 8 * (1 + ST + i % ST); };
  auto stage = [&](int i) { return kv_s + (i % ST) * 2 * C::KV_BYTES; };  // K, then V

  const int tid = threadIdx.x, wg = tid / 128;
  const int n_rows = p.S * p.G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * C::BM;
  const int b = blockIdx.y / p.K, kvh = blockIdx.y % p.K;
  const Span sp = tile_span(kv, p, b, min(r0 + C::BM, n_rows) - 1, WBN);
  const int n_kt = sp.n_s > 0 ? (sp.hi - sp.lo_a + WBN - 1) / WBN : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<WS_PRODUCER_REGS>();
    if (tid == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int cb = 0; cb < HD / 64; ++cb)
        tma_load_4d(q_s + cb * C::BM * 128, &tm_q, q_full, cb * 64, kvh * p.G, r0 / p.G, b);
      for (int i = 0; i < n_kt; ++i) {
        if (i >= ST) mbar_wait(empty(i), (i / ST - 1) & 1);  // the stage's last use is done
        mbar_expect_tx(full(i), 2 * C::KV_BYTES);
        const int3 c = kv.tma_row(b, kvh, sp.lo_a + i * WBN);
        for (int cb = 0; cb < HD / 64; ++cb) {
          tma_load_4d(stage(i) + cb * WBN * 128, &tm_k, full(i), cb * 64, c.x, c.y, c.z);
          tma_load_4d(stage(i) + C::KV_BYTES + cb * WBN * 128, &tm_v, full(i), cb * 64, c.x, c.y, c.z);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<WS_CONSUMER_REGS>();
  const int w = wg - 1, ct = tid % 128, warp = ct / 32, lane = ct % 32;
  const int lo = sp.lo, len = kv.len(b), q_offset = kv.offset(b);
  const int wr0 = r0 + w * 64;
  const bool wg_live = wr0 < n_rows;
  const int row_a = wr0 + warp * 16 + lane / 4;
  Rows rs;
  rs.qpos_a = q_offset + row_a / p.G;
  rs.qpos_b = q_offset + (row_a + 8) / p.G;
  const int wg_first = q_offset + wr0 / p.G;
  const int wg_last = q_offset + (min(wr0 + 64, n_rows) - 1) / p.G;
  const int kc = 2 * (lane % 4);

  float o[HD / 2], s[WBN / 2];
  uint32_t pf[WBN / 16][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < WBN / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < WBN / 16; ++i) pf[i][0] = pf[i][1] = pf[i][2] = pf[i][3] = 0u;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int k0 = sp.lo_a + i * WBN;
    const uint32_t ks = stage(i), vs = ks + C::KV_BYTES;
    mbar_wait(full(i), (i / ST) & 1);
    if (wg_live && !(p.causal && k0 > wg_last)) {  // some row of this warpgroup sees the tile
      if (k0 < lo || k0 + WBN > len) {  // a window edge cuts it: zero the rows outside
        for (int x = ct; x < WBN * CH; x += 128) {
          const int r = x / CH, kp = k0 + r;
          if (kp < lo || kp >= len) {
            const uint32_t off = tile_off<WBN>(r, x % CH);
            st_shared_zero16(ks + off);
            st_shared_zero16(vs + off);
          }
        }
        fence_proxy_async();
        bar_sync(1 + w, 128);  // this warpgroup's 128 threads
      }
      const bool masked = k0 < lo || k0 + WBN > len || (p.causal && k0 + WBN - 1 > wg_first);
      float al_a, al_b;
      wgmma_fence();
      mma_qk<HD, WBN>(s, q_s, C::BM, w * 8192, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      online_softmax<WBN>(s, rs, k0, kc, masked, lo, len, p.causal, p.scale_log2, al_a, al_b);
      take_p<HD, WBN>(o, s, pf, al_a, al_b);
      wgmma_fence();
      mma_pv<HD, WBN>(o, pf, vs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);
    }
    mbar_arrive(empty(i));
  }
  if (wg_live) store_rows<HD>(p, o, rs, row_a, n_rows, b, kvh, 0, lane);
}

// ---------------------------------------------------------------------------
// decode routine: one query per row, split-KV, mma.sync
// ---------------------------------------------------------------------------
//
// One warp per (split, kv head, batch row). The G query heads of the kv
// head are rows 0..G-1 of a 16-row m16n8k16 tile (G <= 16; at G = 4 three
// quarters of its rows are zero, which costs nothing under the byte bound);
// their A fragments are loaded once into registers. K/V tiles of 16 keys
// (16-byte cp.async, zero-filled outside the window) stream through a ring
// of DEC_STAGES; per tile, S = Q K^T is 2 x hd/16 mma with K's B fragments
// from ldmatrix, the softmax runs on the fragments (quad shuffles, no
// per-key warp reduction), and O += P V is hd/8 mma with V's B fragments
// from ldmatrix.trans. O (16 x hd fp32) lives in registers.

constexpr int DBN = 16;  // keys per tile
constexpr int DEC_STAGES = 4;

template <int HD, class KV>
__global__ void __launch_bounds__(32) decode_kernel(Params p, KV kv) {
  constexpr int CH = HD / 8;
  constexpr int TILE = DBN * HD * 2;  // bytes of one K or V tile
  __shared__ __align__(1024) unsigned char smem[DEC_STAGES * 2 * TILE];
  const uint32_t s_base = smem_u32(smem);
  const int lane = threadIdx.x, g = lane / 4, kc = 2 * (lane % 4);
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, bk = b * p.K + kvh;
  const Span sp = tile_span(kv, p, b, 0, DBN);
  if (split >= max(sp.n_s, 1)) return;
  const int lo = sp.lo, len = kv.len(b);
  const int k_begin = sp.lo_a + split * p.split_keys;
  const int k_end = min(sp.hi, k_begin + p.split_keys);
  const int n_kt = k_end > k_begin ? (k_end - k_begin + DBN - 1) / DBN : 0;

  // Tile i's 16 rows from its first key's row (a tile starts on a multiple
  // of 16 and never crosses a block of the arena; dense rows are
  // contiguous): one table lookup per tile, not per key. A row outside the
  // window is zero-filled, its source (the tile's first row) never read.
  // Each lane copies chunk lc of rows lr, lr + 32 / CH, ...
  const int lc = lane % CH, lr = lane / CH;
  auto load_kv = [&](int i) {
    const int k0 = k_begin + i * DBN;
    const uint32_t ks = s_base + (i % DEC_STAGES) * 2 * TILE, vs = ks + TILE;
    const bf16* kr = kv.k_row(b, kvh, k0) + lc * 8;
    const bf16* vr = kv.v_row(b, kvh, k0) + lc * 8;
#pragma unroll
    for (int n = lr; n < DBN; n += 32 / CH) {
      const int kp = k0 + n;
      const bool in = kp >= lo && kp < len;
      const int step = in ? n * HD : 0;
      const uint32_t off = tile_off<DBN>(n, lc);
      cp_async16(ks + off, kr + step, in);
      cp_async16(vs + off, vr + step, in);
    }
  };
#pragma unroll
  for (int i = 0; i < DEC_STAGES - 1; ++i) {
    if (i < n_kt) load_kv(i);
    cp_async_commit();
  }

  // Q's A fragments: rows g and g + 8 are heads kvh * G + row (zero past G)
  uint32_t qf[HD / 16][4];
  {
    const bf16* qa = p.q + b * p.q_sb + (long long)(kvh * p.G + g) * p.q_sh + kc;
    const bf16* qb = qa + 8 * p.q_sh;
    const bool ra = g < p.G, rb = g + 8 < p.G;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qf[kk][0] = ra ? *reinterpret_cast<const uint32_t*>(qa + 16 * kk) : 0u;
      qf[kk][1] = rb ? *reinterpret_cast<const uint32_t*>(qb + 16 * kk) : 0u;
      qf[kk][2] = ra ? *reinterpret_cast<const uint32_t*>(qa + 16 * kk + 8) : 0u;
      qf[kk][3] = rb ? *reinterpret_cast<const uint32_t*>(qb + 16 * kk + 8) : 0u;
    }
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  for (int i = 0; i < n_kt; ++i) {
    cp_async_wait<DEC_STAGES - 2>();
    __syncwarp();  // tile i has landed; every lane is done with tile i - 1
    if (i + DEC_STAGES - 1 < n_kt) load_kv(i + DEC_STAGES - 1);
    cp_async_commit();
    const int k0 = k_begin + i * DBN;
    const uint32_t ks = s_base + (i % DEC_STAGES) * 2 * TILE, vs = ks + TILE;

    // S = Q K^T: two 8-key groups j; ldmatrix.x4 gives both hd steps of a
    // 32-wide slice (chunks 4kk2 .. 4kk2 + 3 of keys 8j .. 8j + 7)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk2 = 0; kk2 < HD / 32; ++kk2) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + tile_off<DBN>(8 * j + lane % 8, 4 * kk2 + lane / 8));
        mma_16816(s[j], qf[2 * kk2], r[0], r[1]);
        mma_16816(s[j], qf[2 * kk2 + 1], r[2], r[3]);
      }
    }

    // online softmax: s[j][e] is row g, key k0 + 8j + kc + e; s[j][2 + e] row g + 8
    const bool masked = k0 < lo || k0 + DBN > len;
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (masked) {
          const int kp = k0 + 8 * j + kc + e;
          if (kp < lo || kp >= len) s[j][e] = s[j][2 + e] = NEG_INF;
        }
        mx_a = fmaxf(mx_a, s[j][e]);
        mx_b = fmaxf(mx_b, s[j][2 + e]);
      }
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    const float mn_a = fmaxf(m_a, mx_a == NEG_INF ? NEG_INF : mx_a * p.scale_log2);
    const float mn_b = fmaxf(m_b, mx_b == NEG_INF ? NEG_INF : mx_b * p.scale_log2);
    const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xa = s[j][e], xb = s[j][2 + e];
        float pa = ex2(fmaf(xa, p.scale_log2, -mn_a)), pb = ex2(fmaf(xb, p.scale_log2, -mn_b));
        if (masked) {
          pa = xa == NEG_INF ? 0.f : pa;
          pb = xb == NEG_INF ? 0.f : pb;
        }
        s[j][e] = pa;
        s[j][2 + e] = pb;
        sum_a += pa;
        sum_b += pb;
      }
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
    const uint32_t pf[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};

    // O += P V: ldmatrix.x4.trans gives the B fragments of two 8-wide hd
    // groups (chunks 2n2, 2n2 + 1; keys 0-7 and 8-15)
#pragma unroll
    for (int n2 = 0; n2 < HD / 16; ++n2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, vs + tile_off<DBN>(lane % 8 + 8 * ((lane / 8) % 2), 2 * n2 + lane / 16));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* on = o[2 * n2 + h];
        on[0] *= al_a;
        on[1] *= al_a;
        on[2] *= al_b;
        on[3] *= al_b;
        mma_16816(on, pf, r[2 * h], r[2 * h + 1]);
      }
    }
  }
  cp_async_wait<0>();

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = g + 8 * half;
    if (row >= p.G) continue;
    const float m = half ? m_b : m_a, l = half ? l_b : l_a;
    if (p.part_m == nullptr) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      bf16* orow = p.o + ((long long)b * p.H + kvh * p.G + row) * HD + kc;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    } else {
      const long long ix = ((long long)bk * p.n_splits + split) * p.G + row;
      if (lane % 4 == 0) {
        p.part_m[ix] = m;
        p.part_l[ix] = l;
      }
      float* arow = p.part_acc + ix * HD + kc;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(arow + 8 * n) = make_float2(o[n][2 * half], o[n][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// decode routine over an int8 payload: one query per row, split-KV, mma.sync
// ---------------------------------------------------------------------------
//
// decode_kernel's function over the int8 cache and arena (the int8 policy of
// the chunk routine, read a tile at a time: keys kp .. kp + 15 from a
// multiple of 16 are contiguous rows, and their scales too). One warp per
// (split, kv head, batch row), the G heads as rows of an m16n8k16 tile, S,
// the softmax and O on the mma fragments, partials merged by merge_kernel.
// The int8 tiles are never widened in shared memory: each fragment is
// widened in registers as ldmatrix hands it over (i8x4_to_bf16x4_scaled:
// exactly, then times its key's scale, rounded once to bf16).
//
// - S = Q K^T. ldmatrix gives lane (g, t) the word of bytes 4t .. 4t + 3 of
//   key g's 16 hd values in each hd step, which is its B fragment (k rows
//   2t, 2t + 1 and 2t + 8, 2t + 9) once the hd order inside a step is
//   permuted so: Q's A fragments are loaded with the same permutation, so
//   the dot products are unchanged (only their fp32 summation order).
// - O += P V. V's B fragment needs one hd column of keys 2t, 2t + 1 (and
//   + 8), which a row-major tile does not hold in one word; ldmatrix.trans
//   over int8 pairs as b16 gives lane (g, t) keys 2t and 2t + 1 of hd 2g and
//   2g + 1 in one word: its bytes (0, 2) are the B fragment of an mma whose
//   column g is hd 2g, bytes (1, 3) that of an mma whose column g is hd
//   2g + 1. O's fragments are kept in that column order and written back
//   in hd order (lane t holds hd 4t .. 4t + 3 of each 16).
// - Scales: each widened K and V value is multiplied by its key's scale
//   in fp32 and rounded once to bf16, which is the plain version's
//   dequantized cache, and P is bf16(p): decode_kernel's arithmetic over
//   that cache. (Scaling the scores instead, and the PV operand as
//   bf16(p * v-scale), is more exact, but it moved one row of a tp rank's
//   K = 1 paged decode past 2^-7 from the plain version on the H100,
//   sharpened queries amplifying the plain version's own K rounding.)
//   A key's K fragment word is one key (8j + g), its V pair keys kc and
//   kc + 1. A scale outside the window (it may be NaN) reaches only its
//   own key's score column, which is selected to NEG_INF, and its v-scale
//   is selected to 0. A 16-byte piece of four scales is read whole when it
//   holds a key of the window.
//
// A 16-key int8 tile is half a bf16 one, so the ring has twice
// decode_kernel's stages: DEC_Q8_STAGES - 1 tiles in flight per warp, 28 KB
// at hd = 128 against decode_kernel's 24.

constexpr int DEC_Q8_STAGES = 8;

// byte offset of 16-byte chunk c of row r in a tile of int8 rows of HD
// bytes, swizzled so that the 8 rows of an ldmatrix matrix (8 rows of one
// chunk) hit 8 different bank groups
template <int HD>
__device__ __forceinline__ uint32_t i8_off(int r, int c) {
  if constexpr (HD == 128) return r * 128 + ((c ^ (r & 7)) << 4);
  else return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// four int8 (one word, bytes x0 .. x3) times their scales in fp32, each
// rounded once to bf16: lo = (x0 s0, x1 s1), hi = (x2 s0, x3 s1)
__device__ __forceinline__ void i8x4_to_bf16x4_scaled(uint32_t w, float s0, float s1, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = pack_bf16(f0 * s0, f1 * s1);
  hi = pack_bf16(f2 * s0, f3 * s1);
}

template <int HD, class KV>
__global__ void __launch_bounds__(32) decode_q8_kernel(Params p, KV kv) {
  constexpr int CH8 = HD / 16;                   // 16-byte chunks of an int8 row
  constexpr int TILE = DBN * HD;                 // bytes of one int8 K or V tile
  constexpr int STAGE = 2 * TILE + 2 * DBN * 4;  // K, V, k-scales, v-scales
  constexpr int ST = DEC_Q8_STAGES;
  __shared__ __align__(128) unsigned char smem[ST * STAGE];
  const uint32_t s_base = smem_u32(smem);
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4, kc = 2 * t;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, bk = b * p.K + kvh;
  const Span sp = tile_span(kv, p, b, 0, DBN);
  if (split >= max(sp.n_s, 1)) return;
  const int lo = sp.lo, len = kv.len(b);
  const int k_begin = sp.lo_a + split * p.split_keys;
  const int k_end = min(sp.hi, k_begin + p.split_keys);
  const int n_kt = k_end > k_begin ? (k_end - k_begin + DBN - 1) / DBN : 0;

  // Tile i's 16 rows from its first key's (a tile never crosses a block of
  // the arena; rows outside the window are zero-filled and never read).
  // Each lane copies chunks lane, lane + 32, ... of K and V; lanes 0-7 the
  // four 16-byte pieces of k-scales and of v-scales.
  auto load_kv = [&](int i) {
    const int k0 = k_begin + i * DBN;
    const uint32_t ks = s_base + (i % ST) * STAGE, vs = ks + TILE;
    const int8_t* kr = kv.k_row(b, kvh, k0);
    const int8_t* vr = kv.v_row(b, kvh, k0);
#pragma unroll
    for (int u = 0; u < DBN * CH8 / 32; ++u) {
      const int x = lane + 32 * u, n = x / CH8, c = x % CH8, kp = k0 + n;
      const bool in = kp >= lo && kp < len;
      cp_async16(ks + i8_off<HD>(n, c), kr + n * HD + c * 16, in);
      cp_async16(vs + i8_off<HD>(n, c), vr + n * HD + c * 16, in);
    }
    if (lane < 8) {
      const int n = 4 * (lane % 4), kp = k0 + n;
      const float* src = lane < 4 ? kv.k_scales(b, kvh, k0) : kv.v_scales(b, kvh, k0);
      cp_async16(vs + TILE + (lane / 4) * (DBN * 4) + n * 4, src + n, kp + 3 >= lo && kp < len);
    }
  };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n_kt) load_kv(i);
    cp_async_commit();
  }

  // Q's A fragments, hd permuted inside each step of 16: lane t's values
  // 4t .. 4t + 3 of rows g and g + 8 (heads kvh * G + row, zero past G)
  uint32_t qf[HD / 16][4];
  {
    const bf16* qa = p.q + b * p.q_sb + (long long)(kvh * p.G + g) * p.q_sh + 4 * t;
    const bf16* qb = qa + 8 * p.q_sh;
    const bool ra = g < p.G, rb = g + 8 < p.G;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint2 xa = ra ? *reinterpret_cast<const uint2*>(qa + 16 * kk) : make_uint2(0u, 0u);
      const uint2 xb = rb ? *reinterpret_cast<const uint2*>(qb + 16 * kk) : make_uint2(0u, 0u);
      qf[kk][0] = xa.x;
      qf[kk][1] = xb.x;
      qf[kk][2] = xa.y;
      qf[kk][3] = xb.y;
    }
  }

  // o[2s] and o[2s + 1]: hd 16s + 2n and 16s + 2n + 1 at fragment column n
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  for (int i = 0; i < n_kt; ++i) {
    cp_async_wait<ST - 2>();
    __syncwarp();  // tile i has landed; every lane is done with tile i - 1
    if (i + ST - 1 < n_kt) load_kv(i + ST - 1);
    cp_async_commit();
    const int k0 = k_begin + i * DBN;
    const uint32_t ks = s_base + (i % ST) * STAGE, vs = ks + TILE;
    const float* sc = reinterpret_cast<const float*>(smem + (i % ST) * STAGE + 2 * TILE);

    // S = Q K^T: two 8-key groups j; ldmatrix.x4 gives the words of four hd
    // steps (chunks 4q .. 4q + 3 of keys 8j .. 8j + 7), each of key 8j + g,
    // dequantized by its k-scale
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const float kg[2] = {sc[g], sc[8 + g]};
#pragma unroll
    for (int q4 = 0; q4 < CH8 / 4; ++q4) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + i8_off<HD>(8 * j + lane % 8, 4 * q4 + lane / 8));
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t b0, b1;
          i8x4_to_bf16x4_scaled(r[w], kg[j], kg[j], b0, b1);
          mma_16816(s[j], qf[4 * q4 + w], b0, b1);
        }
      }
    }

    // the online softmax: s[j][e] is row g, key k0 + 8j + kc + e; s[j][2 +
    // e] row g + 8
    const bool masked = k0 < lo || k0 + DBN > len;
    float vsc[2][2];
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 vx = *reinterpret_cast<const float2*>(sc + DBN + 8 * j + kc);
      vsc[j][0] = vx.x;
      vsc[j][1] = vx.y;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (masked) {
          // a scale outside the window may be NaN: its score is selected
          // to NEG_INF and its v-scale to 0
          const int kp = k0 + 8 * j + kc + e;
          const bool in = kp >= lo && kp < len;
          vsc[j][e] = in ? vsc[j][e] : 0.f;
          s[j][e] = in ? s[j][e] : NEG_INF;
          s[j][2 + e] = in ? s[j][2 + e] : NEG_INF;
        }
        mx_a = fmaxf(mx_a, s[j][e]);
        mx_b = fmaxf(mx_b, s[j][2 + e]);
      }
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    const float mn_a = fmaxf(m_a, mx_a == NEG_INF ? NEG_INF : mx_a * p.scale_log2);
    const float mn_b = fmaxf(m_b, mx_b == NEG_INF ? NEG_INF : mx_b * p.scale_log2);
    const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xa = s[j][e], xb = s[j][2 + e];
        float pa = ex2(fmaf(xa, p.scale_log2, -mn_a)), pb = ex2(fmaf(xb, p.scale_log2, -mn_b));
        if (masked) {
          pa = xa == NEG_INF ? 0.f : pa;
          pb = xb == NEG_INF ? 0.f : pb;
        }
        sum_a += pa;
        sum_b += pb;
        s[j][e] = pa;
        s[j][2 + e] = pb;
      }
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
    const uint32_t pf[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};

    // O += P V: ldmatrix.x4.trans gives two hd chunks 2m, 2m + 1 (keys 0-7
    // and 8-15 of each), each word the B fragments of two mma; a fragment's
    // pair is keys kc, kc + 1 (of 0-7, then of 8-15), scaled by vsc[j]
#pragma unroll
    for (int m = 0; m < CH8 / 2; ++m) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, vs + i8_off<HD>(lane % 8 + 8 * ((lane / 8) % 2), 2 * m + lane / 16));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // bytes (0, 2) and (1, 3): the pairs of hd 2g and of hd 2g + 1
        uint32_t e0, d0, e1, d1;
        i8x4_to_bf16x4_scaled(__byte_perm(r[2 * h], 0u, 0x3120), vsc[0][0], vsc[0][1], e0, d0);
        i8x4_to_bf16x4_scaled(__byte_perm(r[2 * h + 1], 0u, 0x3120), vsc[1][0], vsc[1][1], e1, d1);
        float* oe = o[4 * m + 2 * h];
        float* od = o[4 * m + 2 * h + 1];
        oe[0] *= al_a;
        oe[1] *= al_a;
        oe[2] *= al_b;
        oe[3] *= al_b;
        od[0] *= al_a;
        od[1] *= al_a;
        od[2] *= al_b;
        od[3] *= al_b;
        mma_16816(oe, pf, e0, e1);
        mma_16816(od, pf, d0, d1);
      }
    }
  }
  cp_async_wait<0>();

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = g + 8 * half;
    if (row >= p.G) continue;
    const float m = half ? m_b : m_a, l = half ? l_b : l_a;
    // hd 16s + 4t .. 4t + 3 of this row: o[2s][x], o[2s + 1][x], o[2s][x + 1], o[2s + 1][x + 1]
    const int x = 2 * half;
    if (p.part_m == nullptr) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      bf16* orow = p.o + ((long long)b * p.H + kvh * p.G + row) * HD + 4 * t;
#pragma unroll
      for (int s = 0; s < HD / 16; ++s)
        *reinterpret_cast<uint2*>(orow + 16 * s) =
            make_uint2(pack_bf16(o[2 * s][x] * inv, o[2 * s + 1][x] * inv),
                       pack_bf16(o[2 * s][x + 1] * inv, o[2 * s + 1][x + 1] * inv));
    } else {
      const long long ix = ((long long)bk * p.n_splits + split) * p.G + row;
      if (t == 0) {
        p.part_m[ix] = m;
        p.part_l[ix] = l;
      }
      float* arow = p.part_acc + ix * HD + 4 * t;
#pragma unroll
      for (int s = 0; s < HD / 16; ++s)
        *reinterpret_cast<float4*>(arow + 16 * s) =
            make_float4(o[2 * s][x], o[2 * s + 1][x], o[2 * s][x + 1], o[2 * s + 1][x + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// merge of split-KV partials
// ---------------------------------------------------------------------------

// One thread per 4 output values of a query row; grid (ceil(S*G*hd/4 / 256),
// B*K). block_rows and tile are the split pass's row tile and key tile, so
// n_s is the split pass's own count; a row with no visible key writes 0.
template <int HD, class KV>
__global__ void __launch_bounds__(256) merge_kernel(Params p, KV kv, int block_rows, int tile) {
  constexpr int D4 = HD / 4;
  const int n_rows = p.S * p.G;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows * D4) return;
  const int bk = blockIdx.y, b = bk / p.K, kvh = bk % p.K;
  const int row = i / D4, d = (i % D4) * 4;
  const int n_s = tile_span(kv, p, b, min((row / block_rows + 1) * block_rows, n_rows) - 1, tile).n_s;
  const long long ix0 = (long long)bk * p.n_splits * n_rows + row;
  float mt = NEG_INF;
#pragma unroll 4
  for (int s = 0; s < n_s; ++s) mt = fmaxf(mt, p.part_m[ix0 + (long long)s * n_rows]);
  float lt = 0.f;
  float4 at = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = 0; s < n_s; ++s) {
    const long long ix = ix0 + (long long)s * n_rows;
    const float e = ex2(p.part_m[ix] - mt);
    const float4 a = *reinterpret_cast<const float4*>(p.part_acc + ix * HD + d);
    lt += p.part_l[ix] * e;
    at.x += a.x * e;
    at.y += a.y * e;
    at.z += a.z * e;
    at.w += a.w * e;
  }
  const float inv = 1.f / fmaxf(lt, 1e-30f);
  const int t = row / p.G, h = kvh * p.G + row % p.G;
  uint2 out;
  out.x = pack_bf16(at.x * inv, at.y * inv);
  out.y = pack_bf16(at.z * inv, at.w * inv);
  *reinterpret_cast<uint2*>(p.o + ((long long)(b * p.S + t) * p.H + h) * HD + d) = out;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int HD, class KV>
int launch_merge(const Params& p, const KV& kv, int B, int block_rows, int tile, cudaStream_t st) {
  const int n = p.S * p.G * (HD / 4);
  merge_kernel<HD, KV><<<dim3((n + 255) / 256, B * p.K), 256, 0, st>>>(p, kv, block_rows, tile);
  return (int)cudaGetLastError();
}

// a chunk-routine kernel of bm-row tiles (bm / 64 warpgroups) over the
// (row tile, batch row x kv head, split) grid, then the merge pass
template <int HD, class KV>
int launch_chunk_grid(void (*kernel)(Params, KV), int bm, int smem, const Params& p, const KV& kv, int B,
                      cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S * p.G + bm - 1) / bm, B * p.K, p.n_splits);
  kernel<<<grid, bm * 2, smem, st>>>(p, kv);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.part_m == nullptr) return (int)err;
  return launch_merge<HD>(p, kv, B, bm, CBN, st);
}

template <int HD, int WG, int STAGES, class KV>
int launch_chunk(const Params& p, const KV& kv, int B, cudaStream_t st) {
  using C = ChunkCfg<HD, WG, STAGES>;
  return launch_chunk_grid<HD>(chunk_kernel<HD, WG, STAGES, KV>, C::BM, C::SMEM, p, kv, B, st);
}

template <int HD, int WG, int STAGES, int NB, class KV>
int launch_chunk_q8(const Params& p, const KV& kv, int B, cudaStream_t st) {
  using C = ChunkQ8Cfg<HD, WG, STAGES, NB>;
  return launch_chunk_grid<HD>(chunk_q8_kernel<HD, WG, STAGES, NB, KV>, C::BM, C::SMEM, p, kv, B, st);
}

template <int HD, class KV>
int launch_decode(const Params& p, const KV& kv, int B, cudaStream_t st) {
  decode_kernel<HD, KV><<<dim3(p.n_splits, p.K, B), 32, 0, st>>>(p, kv);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.part_m == nullptr) return (int)err;
  return launch_merge<HD>(p, kv, B, p.G, DBN, st);
}

template <int HD, class KV>
int launch_decode_q8(const Params& p, const KV& kv, int B, cudaStream_t st) {
  decode_q8_kernel<HD, KV><<<dim3(p.n_splits, p.K, B), 32, 0, st>>>(p, kv);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.part_m == nullptr) return (int)err;
  return launch_merge<HD>(p, kv, B, p.G, DBN, st);
}

template <int HD, int ST, class KV>
int launch_ws(const Params& p, const KV& kv, const CUtensorMap& tq, const CUtensorMap& tk,
              const CUtensorMap& tv, int B, cudaStream_t st) {
  using C = WsCfg<HD, ST>;
  const auto kernel = ws_kernel<HD, ST, KV>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((p.S * p.G + C::BM - 1) / C::BM, B * p.K), WS_THREADS, C::SMEM, st>>>(p, kv, tq, tk, tv);
  return (int)cudaGetLastError();
}

// Tensor map for ws_kernel of a bf16 tensor [n0, n1, n2, hd] with element
// strides s0, s1, s2 (multiples of 8) and a contiguous head dim: a box of 64
// columns (one 128-byte swizzle line) x box1 rows of dim 2 x box2 rows of
// dim 1, zero fill out of bounds. The encoder is looked up through
// the runtime, so the library needs no -lcuda.
inline int make_tma_4d(CUtensorMap* map, const void* base, long long n0, long long n1, long long n2, int hd,
                       long long s0, long long s1, long long s2, unsigned box1, unsigned box2) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return static_cast<Encode>(nullptr);
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t d[4] = {(cuuint64_t)hd, (cuuint64_t)n2, (cuuint64_t)n1, (cuuint64_t)n0};
  const cuuint64_t s[3] = {2ull * s2, 2ull * s1, 2ull * s0};
  const cuuint32_t box[4] = {64, box1, box2, 1}, unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), d, s, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The warp-specialized routine: one split, 128 query rows per block, G a
// divisor of 128 (a row tile is whole positions); tq, tk, tv as ws_kernel.
template <class KV>
int ws_chunk(const Params& p, const KV& kv, const CUtensorMap& tq, const CUtensorMap& tk,
             const CUtensorMap& tv, int B, int hd, void* stream) {
  if (p.K < 1 || p.H != p.K * p.G || 128 % p.G || p.S < 1 || B < 1 || p.n_splits != 1 ||
      p.part_m != nullptr || p.split_keys < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 2 stages at hd = 128 (160 KB), 4 at hd = 64 (144 KB); one block an SM
  if (hd == 128) return launch_ws<128, 2>(p, kv, tq, tk, tv, B, st);
  if (hd == 64) return launch_ws<64, 4>(p, kv, tq, tk, tv, B, st);
  return (int)cudaErrorInvalidValue;
}

// the shapes and split plan the chunk routines take
inline bool chunk_params_ok(const Params& p, int B) {
  return p.K >= 1 && p.H == p.K * p.G && p.S >= 1 && B >= 1 && p.n_splits >= 1 && p.split_keys >= CBN &&
         p.split_keys % CBN == 0;
}

// block_rows: 64 or 128 query rows per chunk block (one or two warpgroups)
template <class KV>
int chunk(const Params& p, const KV& kv, int B, int hd, int block_rows, void* stream) {
  if (!chunk_params_ok(p, B)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one warpgroup: 3 stages (113 KB, two blocks an SM); two: 2 stages
  // (97 KB at hd = 128; ~160 registers a thread keep one block an SM)
  if (hd == 128 && block_rows == 64) return launch_chunk<128, 1, 3>(p, kv, B, st);
  if (hd == 128 && block_rows == 128) return launch_chunk<128, 2, 2>(p, kv, B, st);
  if (hd == 64 && block_rows == 64) return launch_chunk<64, 1, 3>(p, kv, B, st);
  if (hd == 64 && block_rows == 128) return launch_chunk<64, 2, 2>(p, kv, B, st);
  return (int)cudaErrorInvalidValue;
}

// chunk over an int8 payload, 3 int8 stages: one warpgroup converts into one
// buffer (99 KB at hd = 128, two blocks an SM), two into two (148 KB, one
// block an SM)
template <class KV>
int chunk_q8(const Params& p, const KV& kv, int B, int hd, int block_rows, void* stream) {
  if (!chunk_params_ok(p, B)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128 && block_rows == 64) return launch_chunk_q8<128, 1, 3, 1>(p, kv, B, st);
  if (hd == 128 && block_rows == 128) return launch_chunk_q8<128, 2, 3, 2>(p, kv, B, st);
  if (hd == 64 && block_rows == 64) return launch_chunk_q8<64, 1, 3, 1>(p, kv, B, st);
  if (hd == 64 && block_rows == 128) return launch_chunk_q8<64, 2, 3, 2>(p, kv, B, st);
  return (int)cudaErrorInvalidValue;
}

template <class KV>
int decode(const Params& p, const KV& kv, int B, int hd, void* stream) {
  if (p.K < 1 || p.H != p.K * p.G || p.G > 16 || p.S != 1 || B < 1 || p.n_splits < 1 ||
      p.split_keys < DBN || p.split_keys % DBN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_decode<128>(p, kv, B, st);
  if (hd == 64) return launch_decode<64>(p, kv, B, st);
  return (int)cudaErrorInvalidValue;
}

// decode over an int8 payload: the shapes and split plan of decode, and no
// causality
template <class KV>
int decode_q8(const Params& p, const KV& kv, int B, int hd, void* stream) {
  if (p.K < 1 || p.H != p.K * p.G || p.G > 16 || p.S != 1 || p.causal || B < 1 || p.n_splits < 1 ||
      p.split_keys < DBN || p.split_keys % DBN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_decode_q8<128>(p, kv, B, st);
  if (hd == 64) return launch_decode_q8<64>(p, kv, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn_sm90
