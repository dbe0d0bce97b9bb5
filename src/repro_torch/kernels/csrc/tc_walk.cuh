// The tensor-core causal walk for Hopper (sm_90a), shared by three kernels:
// the contiguous prefill (contiguous_prefill.cu, bf16), the chunked paged
// prefill (prefill_attention.cu, bf16) and the chunk segments of the fused
// mixed kernel (mixed_attention.cu, bf16 and int8 pools).
//
// One block of two warpgroups owns 128 query rows of one kv head, laid out
// as the TPU's [bq*G, Dh] q tile: row r is token r / G and query head
// h*G + r % G, so each K/V tile in shared memory serves all G query heads of
// its kv head. Each warpgroup owns 64 rows; its Q fragments sit in
// registers for the whole walk. Row r (token t) sees keys
// idx < min(total, ctx + t + 1): ctx 0 and total = length for the
// contiguous prefill, the chunk's written context and ctx + chunk length
// for the paged kernels. Rows at or past `live` are written as zeros.
//
// - Products: S = Q Kᵀ is wgmma m64n64k16 with Q from registers and K from
//   shared memory; O += P V is wgmma m64n{Dh}k16 with P from registers (the
//   score accumulators converted in place) and V read transposed. f32
//   accumulators. Every product is retired within its step: accumulators
//   left in flight across steps made ptxas serialise the wgmmas (C7514).
// - Softmax in f32 registers with the reference's m/l/acc algebra
//   (_flash_block_update, in base 2); masks only on tiles that cross the
//   first row's limit; tiles past the last row's limit are never read (the
//   TPU's causal block pruning).
// - Rounding: the TPU computes P V in f32. One bf16 P moves an output by
//   ~1e-3 of its size, enough to flip the bf16 rounding of outputs above 2
//   past a 5e-3 tolerance, so P is split into a bf16 high part and a bf16
//   low part (P - hi), each multiplied by V: P carries 16 bits, at 1.5x the
//   products (TC_WALK_SPLIT_P=0 builds the single-product variant).
//
// Two producers fill the K/V tiles of 64 keys, 128-byte swizzled as wgmma
// reads them:
// - walk_tma (bf16 pools and caches): TMA copies into a ring of 4 stages,
//   each completing on an mbarrier; thread 0 issues them two tiles ahead,
//   and the two warpgroups are tied by no barrier (stages are released on
//   mbarriers), so one's softmax runs under the other's products. Where a
//   tile's rows come from is the Src policy: ContigSrc, one box of 64 keys
//   per 64 dims from a map over [B, T, Hkv, Dh]; PagedSrc, from a map over
//   the pool [NB, BS, Hkv, Dh] whose box is min(BS, 64) positions x 64
//   dims of one kv head: thread 0 reads the table entry (from a copy of
//   the table the block makes in shared memory first) and issues
//   64 / min(BS, 64) boxes per 64 dims into the same stage. The swizzle is
//   a function of the shared address, so boxes that start on 128-byte rows
//   compose into the tile the descriptors read. It takes BS that divides
//   64 or is a multiple of 64 (paged_tma_block). Boxes past the walk are
//   not issued; V rows past it are zeroed in the last tile, and K rows
//   past it are masked, so padding cannot spread NaN.
// - walk_int8 (int8 pools with f32 k_scale / v_scale per pool row): TMA
//   cannot dequantize, so all 256 threads stage the int8 rows and scales
//   by cp.async (rows past the walk: zeros) and write the integers into the
//   bf16 operand layout (|v| <= 127 is exact in bf16), then
//   fence.proxy.async before wgmma reads them. The scales stay out of the
//   operands: column `key` of S is multiplied by k_scale[key] in f32, and
//   v_scale[key] is folded into P, which then goes in three bf16 parts
//   (24 bits, so the scale keeps the precision f32 dequantization gives
//   it); l is summed from the unscaled P. Each tile is converted one step
//   ahead, under the scores, and the warpgroups meet at a block barrier
//   once a tile.
#pragma once

#include <cuda.h>   // CUtensorMap (the driver is reached at run time)
#include <cuda_bf16.h>
#include <string.h>

#include <mutex>

#include "async_copy.cuh"

#ifndef TC_WALK_SPLIT_P
#define TC_WALK_SPLIT_P 1
#endif

namespace tcw {

using bf16 = __nv_bfloat16;
using acp::cp_async16;
using acp::cp_async4;
using acp::cp_async_commit;
using acp::cp_async_wait;
using acp::smem_u32;

constexpr int kWarpgroups = 2;
constexpr int kThreads = kWarpgroups * 128;   // 256
constexpr int kM = kWarpgroups * 64;      // query rows per block
constexpr int kN = 64;                    // keys per K/V tile
constexpr int kStages = 4;                // TMA ring depth
constexpr int kOpStages = 2;              // int8: bf16 operand stages
constexpr int kRawStages = 2;             // int8: staged int8 tiles

// Shared memory of a block: q tile, K/V ring, stage barriers, alignment
// slack, and (paged sources) a copy of the table's first NBT entries.
template <int DH>
constexpr int tma_smem_bytes(int NBT = 0) {
  return (kM + 2 * kStages * kN) * DH * 2 + 16 * kStages + 1024 + 4 * NBT;
}

template <int DH>   // q, operand stages, int8 stages, scales, table
constexpr int int8_smem_bytes(int NBT) {
  return kM * DH * 2 + kOpStages * 2 * kN * DH * 2 +
         kRawStages * 2 * kN * (DH + 4) + kOpStages * 2 * kN * 4 + 1024 +
         4 * NBT;
}

// The block's query rows: r0 .. r0 + out_rows - 1, of which the first
// `live` attend; row r (token t = r / G) sees keys idx < min(total,
// ctx + t + 1).
struct Rows {
  int r0, live, out_rows, ctx, total;
};

// Byte offset of 16-byte chunk c of row r in a tile of R rows of DH bf16,
// the layout wgmma reads with 128-byte swizzling: DH/64 column blocks of
// [R][64], each row 128 bytes, chunk c % 8 of row r at (c % 8) ^ (r % 8).
// The tile starts on a 1024-byte boundary.
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma descriptor of a 128-byte-swizzled operand at p: lbo and sbo in
// bytes (K-major: sbo = 1024 between 8-row groups, lbo unused; MN-major:
// lbo between 64-element blocks of the MN dim, sbo between 8-row groups).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)(lbo >> 4) << 16 | (uint64_t)(sbo >> 4) << 32 |
         1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's product groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching accumulators across an async product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared memory written by threads, then read by wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers in shared memory: `full` completes when a TMA copy's bytes
// have landed (one arrival: the thread that issues it), `empty` when both
// warpgroups are done with a stage (one arrival each).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity) : "memory");
}

// TMA: the box at (c0, c1, c2, c3) of a 4-D tensor map into shared memory
// (128-byte swizzled, as the map says), completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// d (64 x 64, f32) = A (64 x 16, registers) * B (16 x 64) (+ d if
// accumulate), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64), B in shared
// memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128), B in shared
// memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (DH == 128)
    wgmma_rs_n128(o, a, b);
  else
    wgmma_rs_n64(o, a, b);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as bf16 pairs: hi = rn(x, y), lo = rn(x - hi, y - hi).
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// (x, y) as three bf16 pairs: hi = rn(x), mid = rn(x - hi),
// lo = rn(x - hi - mid), and likewise for y.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
}

// 2^x (MUFU.EX2, ~2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------ sources ----
// The first n entries of a block table into shared memory (the caller
// synchronises before reading them).
__device__ __forceinline__ const int* copy_table(int* table,
                                                 const int* __restrict__ bt,
                                                 int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) table[i] = bt[i];
  return table;
}

// K/V tile j (keys j*64 .. j*64 + 63) of kv head h into a stage: K at ks,
// V at vs, [DH/64][64][64] each, landing on bar (expect_tx set here).
// prepare() runs on every thread before the walk, with `table` shared
// memory of the table's size, and is followed by a block barrier.
struct ContigSrc {   // k, v [B, T, Hkv, DH]: one box of 64 keys, past T zeros
  const CUtensorMap* k;
  const CUtensorMap* v;
  int h, b;
  __device__ __forceinline__ void prepare(int*, int) {}
  template <int DH>
  __device__ __forceinline__ void load(char* ks, char* vs, uint64_t* bar,
                                       int j, int) const {
    mbar_expect(bar, 2 * kN * DH * 2);
#pragma unroll
    for (int c = 0; c < DH / 64; ++c) {
      tma_load(ks + c * kN * 128, k, bar, c * 64, h, j * kN, b);
      tma_load(vs + c * kN * 128, v, bar, c * 64, h, j * kN, b);
    }
  }
};

struct PagedSrc {    // the pool [NB, BS, Hkv, DH] through one block table
  const CUtensorMap* k;
  const CUtensorMap* v;
  const int* bt;       // the table; after prepare(), its copy in shared
  int bs, h;           // memory (thread 0 then waits on no global read)
  __device__ __forceinline__ void prepare(int* table, int nkeys) {
    bt = copy_table(table, bt, (nkeys + bs - 1) / bs);
  }
  template <int DH>
  __device__ __forceinline__ void load(char* ks, char* vs, uint64_t* bar,
                                       int j, int nkeys) const {
    const int rows = min(bs, kN);        // positions per box
    const int n = min(kN / rows, (nkeys - j * kN + rows - 1) / rows);
    mbar_expect(bar, 2 * n * rows * DH * 2);
    for (int i = 0; i < n; ++i) {        // boxes below nkeys only
      const int key = j * kN + i * rows;
      const int blk = bt[key / bs], pos = key % bs;
#pragma unroll
      for (int c = 0; c < DH / 64; ++c) {
        tma_load(ks + c * kN * 128 + i * rows * 128, k, bar, c * 64, h, pos,
                 blk);
        tma_load(vs + c * kN * 128 + i * rows * 128, v, bar, c * 64, h, pos,
                 blk);
      }
    }
  }
};

// ---------------------------------------------------------- consumers ----
// What one warpgroup keeps for its 64 rows: Q fragments, O, m, l, and the
// softmax's P fragments. Warpgroup g owns rows 64*g .. 64*g + 63 of the
// block; a wgmma accumulator element 4*n + e of the block's warp w (of 8)
// is row 16*w + lane/4 (e < 2) or that + 8 (e >= 2), column
// 8*n + (lane%4)*2 + (e&1).
template <int DH>
struct Warpgroup {
  static constexpr int KS = DH / 16;     // k-steps of Q Kᵀ
  static constexpr int NS = kN / 8;      // key columns of 8 in S
  uint32_t qf[KS][4];
  float o[DH / 2];
  float m0, m1, l0, l1;                  // l: this lane's part
  uint32_t ph[kN / 16][4], pl[kN / 16][4], pm[kN / 16][4];
  float al0, al1;
  int la, lb;                            // this thread's two rows' limits

  __device__ __forceinline__ void init(const char* q_s, int warp, int lane,
                                       const Rows& rw, int G) {
    const float kInf = __int_as_float(0x7f800000);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    m0 = m1 = -kInf;
    l0 = l1 = 0.f;
    al0 = al1 = 0.f;
    // this thread's rows; rows at or past `live` see no key (they are
    // written as zeros, and must not read keys past the walk)
    const int ra = rw.r0 + warp * 16 + (lane >> 2);
    la = ra - rw.r0 < rw.live ? min(rw.total, rw.ctx + ra / G + 1) : 0;
    lb = ra + 8 - rw.r0 < rw.live ? min(rw.total, rw.ctx + (ra + 8) / G + 1)
                                  : 0;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldsm_x4(qf[kk], q_s + swz<kM>(warp * 16 + (lane & 7) +
                                        (((lane >> 3) & 1) << 3),
                                    kk * 2 + (lane >> 4)));
  }

  // S = Q Kᵀ of the K tile at ks: 64 rows x kN keys, issued async
  __device__ __forceinline__ void scores(float (&sc)[NS * 4],
                                         const char* ks) {
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs_n64_k(sc, qf[kk],
                     desc(ks + (kk >> 2) * kN * 128 + (kk & 3) * 32, 16,
                          1024),
                     kk > 0);
    wgmma_commit();
  }

  // Softmax of tile j's scores (ops.py:_flash_block_update on raw scores,
  // m raw; p = 2^(s * scale * log2(e) - m * scale * log2(e))): P as bf16
  // hi and lo A fragments, and O's rescale (al0, al1) for P V. `mask`: the
  // tile crosses a row's limit. int8 pools (kScaled): column key of S times
  // ksc[key], and P times vsc[key] after l is summed, in three bf16 parts
  // (hi, pm, lo: 24 bits): with two, a row over a few keys, whose output
  // is nearly one V row times its scale, carried the scale with 16 bits
  // and flipped the bf16 rounding of outputs above 2.
  template <bool kScaled>
  __device__ __forceinline__ void softmax(float (&s)[NS * 4], int j,
                                          bool mask, int lane,
                                          float scale_log2,
                                          const float* ksc,
                                          const float* vsc) {
    const float kInf = __int_as_float(0x7f800000);
    const int j0 = j * kN;
    if constexpr (kScaled) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float2 kv =
            *reinterpret_cast<const float2*>(ksc + n * 8 + (lane & 3) * 2);
        s[4 * n] *= kv.x;
        s[4 * n + 1] *= kv.y;
        s[4 * n + 2] *= kv.x;
        s[4 * n + 3] *= kv.y;
      }
    }
    if (mask) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + n * 8 + (lane & 3) * 2 + (e & 1);
          if (key >= (e < 2 ? la : lb)) s[4 * n + e] = -kInf;
        }
    }
    float mx0 = -kInf, mx1 = -kInf;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float base0 = mn0 == -kInf ? 0.f : mn0 * scale_log2;
    const float base1 = mn1 == -kInf ? 0.f : mn1 * scale_log2;
    al0 = ex2(m0 * scale_log2 - base0);
    al1 = ex2(m1 * scale_log2 - base1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[4 * n] = ex2(fmaf(s[4 * n], scale_log2, -base0));
      s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], scale_log2, -base0));
      s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], scale_log2, -base1));
      s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], scale_log2, -base1));
      ps0 += s[4 * n] + s[4 * n + 1];
      ps1 += s[4 * n + 2] + s[4 * n + 3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    if constexpr (kScaled) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float2 vv =
            *reinterpret_cast<const float2*>(vsc + n * 8 + (lane & 3) * 2);
        s[4 * n] *= vv.x;
        s[4 * n + 1] *= vv.y;
        s[4 * n + 2] *= vv.x;
        s[4 * n + 3] *= vv.y;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kScaled)
          split3(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], ph[kk][i],
                 pm[kk][i], pl[kk][i]);
        else
          split2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], ph[kk][i],
                 pl[kk][i]);
      }
  }

  // O = O * 2^(m_old - m) + P V of the V tile at vs, issued async
  template <bool kScaled>
  __device__ __forceinline__ void pv(const char* vs) {
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      o[4 * n] *= al0;
      o[4 * n + 1] *= al0;
      o[4 * n + 2] *= al1;
      o[4 * n + 3] *= al1;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const uint64_t bv = desc(vs + kk * 16 * 128, kN * 128, 1024);
      wgmma_pv<DH>(o, ph[kk], bv);
#if TC_WALK_SPLIT_P
      wgmma_pv<DH>(o, pl[kk], bv);
#endif
      if constexpr (kScaled) wgmma_pv<DH>(o, pm[kk], bv);
    }
    wgmma_commit();
  }

  // ops.py:_flash_finish: acc / l, l == 0 -> 1; rows at or past `live`
  // (and below out_rows) are written as zeros
  __device__ __forceinline__ void finish(bf16* __restrict__ out_seg,
                                         const Rows& rw, int warp, int lane,
                                         int h, int H, int G) {
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
    const int ra = rw.r0 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ra + 8 * half;
      if (r - rw.r0 >= rw.out_rows) continue;
      const bool live = r - rw.r0 < rw.live;
      const float inv = half ? inv1 : inv0;
      bf16* dst = out_seg + ((int64_t)(r / G) * H + h * G + r % G) * DH +
                  (lane & 3) * 2;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(live ? o[4 * n + 2 * half] * inv : 0.f,
                                  live ? o[4 * n + 2 * half + 1] * inv : 0.f);
    }
  }
};

// Keys the block's rows need (causal pruning: up to its last live row).
__device__ __forceinline__ int walk_keys(const Rows& rw, int G) {
  return rw.live <= 0 ? 0
                      : min(rw.total, rw.ctx + (rw.r0 + rw.live - 1) / G + 1);
}

// The block's q tile (rows past `live`: zeros) into q_s by cp.async, one
// commit group.
template <int DH>
__device__ __forceinline__ void load_q(char* q_s, const bf16* q_seg,
                                       const Rows& rw, int h, int H, int G) {
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < kM * CH; i += kThreads) {
    const int rr = i / CH, c = i % CH, r = rw.r0 + rr;
    const bool ok = rr < rw.live;
    const bf16* src =
        ok ? q_seg + ((int64_t)(r / G) * H + h * G + r % G) * DH + c * 8
           : q_seg;
    cp_async16(q_s + swz<kM>(rr, c), src, ok);
  }
  cp_async_commit();
}

// Rows r0 .. r0 + out_rows - 1 as zeros (a block with no live row).
template <int DH>
__device__ __forceinline__ void zero_rows(bf16* __restrict__ out_seg,
                                          const Rows& rw, int h, int H,
                                          int G) {
  for (int i = threadIdx.x; i < rw.out_rows * (DH / 8); i += kThreads) {
    const int r = rw.r0 + i / (DH / 8), c = i % (DH / 8);
    *reinterpret_cast<uint4*>(out_seg + ((int64_t)(r / G) * H + h * G +
                                         r % G) * DH + c * 8) =
        make_uint4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------- TMA walk ----
// The block's 128 rows over a bf16 source. In step j a warpgroup issues
// Q K_{j+1}ᵀ, runs the softmax of tile j on the CUDA cores while that
// product runs on the tensor cores, then issues P_j V_j and waits for both.
// Each warpgroup waits for tile j on full[j % kStages] and releases the
// stage on empty after P_j V_j; thread 0 copies tile j + 2 once both have
// released tile j - 2.
template <int DH, class Src>
__device__ __forceinline__ void walk_tma(const bf16* __restrict__ q_seg,
                                         bf16* __restrict__ out_seg,
                                         Src src, const Rows& rw, int h,
                                         int H, int G, float scale_log2,
                                         char* smem_raw) {
  constexpr int NS = kN / 8;
  constexpr int KV_BYTES = kN * DH * 2;  // one K (or V) tile
  if (rw.live <= 0) {
    zero_rows<DH>(out_seg, rw, h, H, G);
    return;
  }
  char* base = smem_raw;
  base += (1024 - (smem_u32(base) & 1023)) & 1023;   // swizzle atoms align
  char* q_s = base;                     // [DH/64][kM][64]
  char* kv_s = q_s + kM * DH * 2;       // stage: K [DH/64][kN][64], then V
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + kStages * 2 * KV_BYTES);
  uint64_t* empty = full + kStages;
  int* table_s = reinterpret_cast<int*>(empty + kStages);

  const int nkeys = walk_keys(rw, G);
  const int nt = (nkeys + kN - 1) / kN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lim_lo = min(rw.total, rw.ctx + rw.r0 / G + 1);   // first row's

  load_q<DH>(q_s, q_seg, rw, h, H, G);
  src.prepare(table_s, nkeys);
  __syncthreads();                      // the table copy, for thread 0
  auto load_kv = [&](int j) {
    char* ks = kv_s + (j % kStages) * 2 * KV_BYTES;
    src.template load<DH>(ks, ks + KV_BYTES, full + j % kStages, j, nkeys);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWarpgroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (nt > 0) load_kv(0);
    if (nt > 1) load_kv(1);
  }
  cp_async_wait<0>();                   // the q tile landed
  fence_async_smem();                   // ... and visible to wgmma
  __syncthreads();                      // (and the barriers initialised)

  Warpgroup<DH> wg;
  wg.init(q_s, warp, lane, rw, G);

  // Tile j landed, and (last tile) its V rows past the walk zeroed.
  auto arrived = [&](int j) {
    mbar_wait(full + j % kStages, (j / kStages) & 1);
    if (j == nt - 1 && nkeys % kN) {
      char* vs = kv_s + (j % kStages) * 2 * KV_BYTES + KV_BYTES;
      const int first = nkeys % kN;
      for (int i = tid; i < (kN - first) * (DH / 8); i += kThreads) {
        const int r = first + i % (kN - first), c = i / (kN - first);
        *reinterpret_cast<uint4*>(vs + swz<kN>(r, c)) =
            make_uint4(0, 0, 0, 0);
      }
      fence_async_smem();
      __syncthreads();                  // (both warpgroups, last tile only)
    }
  };
  auto stage = [&](int j) { return kv_s + (j % kStages) * 2 * KV_BYTES; };

  float s[NS * 4], s_next[NS * 4];
  if (nt > 0) {
    arrived(0);
    wg.scores(s, stage(0));
    wgmma_wait<0>();
    fence_regs(s);
  }
  for (int j = 0; j < nt; ++j) {
    if (tid == 0 && j + 2 < nt) {
      if (j >= 2)
        mbar_wait(empty + (j + 2) % kStages, ((j - 2) / kStages) & 1);
      load_kv(j + 2);
    }
    const bool next = j + 1 < nt;
    if (next) {
      arrived(j + 1);
      wg.scores(s_next, stage(j + 1));
    }
    wg.template softmax<false>(s, j, j * kN + kN > lim_lo, lane, scale_log2,
                               nullptr, nullptr);
    wg.template pv<false>(stage(j) + KV_BYTES);
    wgmma_wait<0>();                    // P V of j and the scores of j + 1
    fence_regs(wg.o);
    if ((tid & 127) == 0) mbar_arrive(empty + j % kStages);
    if (next) {
      fence_regs(s_next);
#pragma unroll
      for (int i = 0; i < NS * 4; ++i) s[i] = s_next[i];
    }
  }
  wg.finish(out_seg, rw, warp, lane, h, H, G);
}

// --------------------------------------------------------- int8 walk ----
// The block's 128 rows over an int8 pool [NB, BS, Hkv, DH] with f32 scales
// [NB, BS, Hkv], through one block table. In step j the block issues
// Q K_jᵀ, converts tile j + 1 into the other operand stage under that
// product, copies tile j + 2's int8 rows into the staging slot tile j left,
// then runs the softmax of tile j and P_j V_j (three products a k-step),
// and meets at one barrier. No scores are left in flight across the
// softmax: the third P part and the conversion need the registers.
template <int DH>
__device__ __forceinline__ void walk_int8(
    const bf16* __restrict__ q_seg, bf16* __restrict__ out_seg,
    const int8_t* __restrict__ k_pool, const int8_t* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ bt, int bs, int Hkv, const Rows& rw, int h,
    int H, int G, float scale_log2, char* smem_raw) {
  constexpr int NS = kN / 8;
  constexpr int KV_BYTES = kN * DH * 2;  // one bf16 K (or V) tile
  constexpr int RAW = kN * DH;           // one int8 K (or V) tile
  constexpr int CR = DH / 16;            // 16-byte int8 chunks per row
  if (rw.live <= 0) {
    zero_rows<DH>(out_seg, rw, h, H, G);
    return;
  }
  char* base = smem_raw;
  base += (1024 - (smem_u32(base) & 1023)) & 1023;
  char* q_s = base;                                  // [DH/64][kM][64]
  char* op_s = q_s + kM * DH * 2;                    // [2][K, V] bf16
  int8_t* raw_s = reinterpret_cast<int8_t*>(op_s + kOpStages * 2 * KV_BYTES);
  float* rsc_s = reinterpret_cast<float*>(raw_s + kRawStages * 2 * RAW);
  float* osc_s = rsc_s + kRawStages * 2 * kN;        // [2][ks 64, vs 64]
  int* table_s = reinterpret_cast<int*>(osc_s + kOpStages * 2 * kN);

  const int nkeys = walk_keys(rw, G);
  const int nt = (nkeys + kN - 1) / kN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lim_lo = min(rw.total, rw.ctx + rw.r0 / G + 1);

  // tile j's int8 rows and scales -> raw stage j % 2 (past nkeys: zeros)
  auto issue = [&](int j) {
    int8_t* kr = raw_s + (j % kRawStages) * 2 * RAW;
    for (int x = tid; x < kN * CR; x += kThreads) {
      const int kk = x / CR, c = x % CR, key = j * kN + kk;
      const bool ok = key < nkeys;
      const int64_t off =
          ok ? (((int64_t)table_s[key / bs] * bs + key % bs) * Hkv + h) *
                       DH + c * 16
             : 0;
      cp_async16(kr + kk * DH + c * 16, k_pool + off, ok);
      cp_async16(kr + RAW + kk * DH + c * 16, v_pool + off, ok);
    }
    if (tid < 2 * kN) {
      const int kk = tid % kN, key = j * kN + kk;
      const bool ok = key < nkeys;
      const int64_t row =
          ok ? ((int64_t)table_s[key / bs] * bs + key % bs) * Hkv + h : 0;
      cp_async4(rsc_s + (j % kRawStages) * 2 * kN + tid,
                (tid < kN ? k_scale : v_scale) + row, ok);
    }
  };
  // raw stage j % 2 -> operand stage j % 2: the integers as bf16 (exact)
  auto convert = [&](int j) {
    const int8_t* kr = raw_s + (j % kRawStages) * 2 * RAW;
    char* ko = op_s + (j % kOpStages) * 2 * KV_BYTES;
    for (int x = tid; x < 2 * kN * (DH / 8); x += kThreads) {
      const int which = x / (kN * (DH / 8)), y = x % (kN * (DH / 8));
      const int r = y / (DH / 8), c = y % (DH / 8);
      const uint2 raw =
          *reinterpret_cast<const uint2*>(kr + which * RAW + r * DH + c * 8);
      const int8_t* b8 = reinterpret_cast<const int8_t*>(&raw);
      uint4 packed;
      uint32_t* p32 = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p32[e] = as_u32(__floats2bfloat162_rn((float)b8[2 * e],
                                              (float)b8[2 * e + 1]));
      *reinterpret_cast<uint4*>(ko + which * KV_BYTES + swz<kN>(r, c)) =
          packed;
    }
    if (tid < 2 * kN)
      osc_s[(j % kOpStages) * 2 * kN + tid] =
          rsc_s[(j % kRawStages) * 2 * kN + tid];
  };
  auto stage = [&](int j) { return op_s + (j % kOpStages) * 2 * KV_BYTES; };
  auto scales = [&](int j) { return osc_s + (j % kOpStages) * 2 * kN; };

  load_q<DH>(q_s, q_seg, rw, h, H, G);  // (commit group 1)
  copy_table(table_s, bt, (nkeys + bs - 1) / bs);
  __syncthreads();                      // the table copy
  if (nt > 0) issue(0);
  cp_async_commit();
  if (nt > 1) issue(1);
  cp_async_commit();
  cp_async_wait<1>();                   // q and tile 0 (this thread's)
  __syncthreads();
  if (nt > 0) convert(0);
  fence_async_smem();                   // q and operand stage 0
  __syncthreads();

  Warpgroup<DH> wg;
  wg.init(q_s, warp, lane, rw, G);

  float s[NS * 4];
  for (int j = 0; j < nt; ++j) {
    wg.scores(s, stage(j));
    if (j + 1 < nt) {                   // under the scores
      cp_async_wait<0>();
      __syncthreads();                  // every thread's copies of j + 1
      convert(j + 1);
      fence_async_smem();
    }
    if (j + 2 < nt) issue(j + 2);       // into the raw stage j left
    cp_async_commit();
    wgmma_wait<0>();
    fence_regs(s);
    const float* sc = scales(j);
    wg.template softmax<true>(s, j, j * kN + kN > lim_lo, lane, scale_log2,
                              sc, sc + kN);
    wg.template pv<true>(stage(j) + KV_BYTES);
    wgmma_wait<0>();
    fence_regs(wg.o);
    __syncthreads();                    // stage j free, j + 1 visible
  }
  wg.finish(out_seg, rw, warp, lane, h, H, G);
}

// ------------------------------------------------------------- host -----
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found at run time (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 map over `base` (dims innermost first, byte strides of dims
// 1..3), 128-byte swizzled, box `box`: the wgmma operand layout. Maps are
// encoded once per (address, dims, strides, box) and kept: a layer's pool
// is encoded on its first call only.
inline int bf16_map(CUtensorMap* map, const void* base,
                    const cuuint64_t (&dims)[4],
                    const cuuint64_t (&strides)[3],
                    const cuuint32_t (&box)[4]) {
  struct Entry {
    const void* base;
    cuuint64_t dims[4], strides[3];
    cuuint32_t box[4];
    CUtensorMap map;
    bool used;
  };
  constexpr int kSlots = 1024;
  static Entry cache[kSlots];
  static std::mutex mu;
  uint64_t hsh = reinterpret_cast<uint64_t>(base) * 0x9E3779B97F4A7C15ull;
  for (int i = 0; i < 4; ++i)
    hsh = (hsh ^ dims[i] ^ ((uint64_t)box[i] << 40)) * 0x100000001B3ull;
  Entry& e = cache[(hsh >> 32) % kSlots];
  std::lock_guard<std::mutex> lock(mu);
  if (e.used && e.base == base && !memcmp(e.dims, dims, sizeof(e.dims)) &&
      !memcmp(e.strides, strides, sizeof(e.strides)) &&
      !memcmp(e.box, box, sizeof(e.box))) {
    *map = e.map;
    return 0;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  e.base = base;
  memcpy(e.dims, dims, sizeof(e.dims));
  memcpy(e.strides, strides, sizeof(e.strides));
  memcpy(e.box, box, sizeof(e.box));
  e.map = *map;
  e.used = true;
  return 0;
}

// Paged pools the TMA walk takes: a box of min(BS, 64) positions tiles a
// 64-key tile exactly (BS divides 64, or 64 divides BS).
inline bool paged_tma_block(int BS) {
  return BS > 0 && (64 % BS == 0 || BS % 64 == 0);
}

// A map over the pool [NB, BS, Hkv, DH] (bf16) whose box is min(BS, 64)
// positions x 64 dims of one kv head.
inline int pool_map(CUtensorMap* map, const void* pool, int NB, int BS,
                    int Hkv, int DH) {
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)Hkv,
                              (cuuint64_t)BS, (cuuint64_t)NB};
  const cuuint64_t strides[3] = {(cuuint64_t)DH * 2,
                                 (cuuint64_t)Hkv * DH * 2,
                                 (cuuint64_t)BS * Hkv * DH * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)(BS < kN ? BS : kN), 1};
  return bf16_map(map, pool, dims, strides, box);
}

}  // namespace tcw
