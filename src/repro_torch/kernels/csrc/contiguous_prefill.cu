// Causal flash prefill over contiguous caches for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/prefill_attention.py::
// prefill_attention (body `_prefill_kernel`): causal GQA of q [B, T, H, Dh]
// against k, v [B, T, Hkv, Dh] with per-row lengths (clamped to T). Key s is
// visible to query t iff s <= t and s < length; a row that sees no key (a
// length-0 row) writes zeros. Rows t >= length still attend their first
// `length` keys, as on the TPU.
//
// What bounds it on an H100: 4*Dh flops per (query head, visible key)
// against K/V read once, about 2*T*G flops a byte of K/V at T tokens, far
// above the ~295 flops/byte where the tensor cores, not the memory, bind.
// So the products must run on the tensor cores, and what is left is to keep
// them fed.
//
// bf16: the tensor-core walk. One block of two warpgroups owns a tile of
// 128 query rows of one kv head, laid out as the TPU's [bq*G, Dh] q tile:
// row r is token r / G and query head h*G + r % G, so each K/V tile in
// shared memory serves all G query heads of its kv head. Each warpgroup
// owns 64 rows; its Q fragments sit in registers for the whole walk.
// - Copies: K/V tiles of 64 keys come by TMA (a 4-D tensor map over
//   [B, T, Hkv, Dh], encoded on the host through the driver entry point)
//   into a ring of 4 stages, 128-byte swizzled as wgmma reads them, each
//   completing on an mbarrier; one thread issues them, two tiles ahead.
//   Keys past T arrive as zeros; V rows past the walk are zeroed in the
//   last tile, so padding cannot spread NaN.
// - Products: S = Q Kᵀ is wgmma m64n64k16 with Q from registers and K from
//   shared memory; O += P V is wgmma m64n{Dh}k16 with P from registers (the
//   score accumulators converted in place) and V read transposed. f32
//   accumulators.
// - Overlap: a warpgroup issues the next tile's scores before the softmax
//   of this one, and the two warpgroups are tied by no barrier (stages are
//   released on mbarriers), so one's softmax runs under the other's
//   products. Every product is retired within its step: accumulators left
//   in flight across steps made ptxas serialise the wgmmas.
// - Softmax in f32 registers with the reference's m/l/acc algebra
//   (_flash_block_update, in base 2); masks only on tiles that cross the
//   tile's first row position or the length; tiles past the last row's
//   position or the length are never read (the TPU's causal block
//   pruning). Blocks run heaviest row tile first, so the causal tail of
//   the grid is short.
//
// Rounding: the TPU computes P V in f32. One bf16 P would move an output
// by ~1e-3 of its size, enough to flip the bf16 rounding of outputs above 2
// past a 5e-3 tolerance. So P is split into a bf16 high part and a bf16 low
// part (P - hi), each multiplied by V: P carries 16 bits, at 1.5x the
// products (CONTIG_PREFILL_SPLIT_P=0 builds the single-product variant that
// tools/profile_torch_prefill_split.py measures).
//
// f32: a second hand-written path, not a fallback: flash_core.cuh's
// CUDA-core walk (16 rows per block, 32-key f32 tiles). f32 exists to hold
// the function to 1e-4, which TF32 or bf16 products cannot do.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcontiguous_prefill.so contiguous_prefill.cu
#include <cuda.h>   // CUtensorMap (the driver is reached at run time)

#include "async_copy.cuh"
#include "flash_core.cuh"

#ifndef CONTIG_PREFILL_SPLIT_P
#define CONTIG_PREFILL_SPLIT_P 1
#endif

namespace {

// ---------------------------------------------------------------- f32 ----
using flash::ContigKeys;
using flash::Rows;

constexpr int kRowsPerThread = flash::kTileRows / flash::kRowGroups;   // 2

// Grid (row tile, kv head, batch row).
template <int DH>
__global__ void __launch_bounds__(flash::kThreads)
contiguous_prefill_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ lengths,
                          float* __restrict__ out, int Tn, int H, int Hkv,
                          float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int r0 = tile * flash::kTileRows;
  const int len = min(max(lengths[b], 0), Tn);
  const int tile_live = max(0, min(Tn * G - r0, flash::kTileRows));
  // causal pruning: the tile's last row sees keys up to its own position
  const int nkeys = tile_live == 0 ? 0
                                   : min(len, (r0 + tile_live - 1) / G + 1);
  const int64_t seg = (int64_t)b * Tn * H * DH;
  Rows<DH, kRowsPerThread> st;
  flash::attend<float, DH, kRowsPerThread>(
      st, q + seg, k, v, ContigKeys{(int64_t)b * Tn}, smem, h, r0, tile_live,
      0, nkeys, nkeys, true, 0, len, H, Hkv, scale);
  flash::finish<float, DH, kRowsPerThread>(st, out + seg, h, r0, Tn * G, H,
                                           Hkv);
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v,
               const void* lengths, void* out, int B, int Tn, int H, int Hkv,
               cudaStream_t stream) {
  constexpr int smem = flash::smem_bytes<DH>();
  static_assert(smem <= 48 * 1024, "tile needs the opt-in smem attribute");
  const int G = H / Hkv;
  const dim3 grid((Tn * G + flash::kTileRows - 1) / flash::kTileRows, Hkv,
                  B);
  contiguous_prefill_kernel<DH><<<grid, flash::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(out), Tn, H, Hkv, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- bf16 ----
using bf16 = __nv_bfloat16;
using acp::cp_async16;
using acp::cp_async_commit;
using acp::cp_async_wait;
using acp::smem_u32;

constexpr int kWarpgroups = 2;
constexpr int kTcThreads = kWarpgroups * 128;   // 256
constexpr int kM = kWarpgroups * 64;      // query rows per block
constexpr int kN = 64;                    // keys per K/V tile
constexpr int kStages = 4;                // K/V ring depth

template <int DH>
constexpr int tc_smem_bytes() {   // q tile, K/V ring, stage barriers, align
  return (kM + 2 * kStages * kN) * DH * (int)sizeof(bf16) +
         16 * kStages + 1024;
}

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

// Shared memory written by threads (cp.async), then read by wgmma.
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

// 1-D grid over (row tile, kv head, batch row), heaviest row tiles first.
// Warpgroup wg owns rows 64*wg .. 64*wg + 63 of the tile; a wgmma
// accumulator element 4*n + e of warp w is row 16*w + lane/4 (e < 2) or
// that + 8 (e >= 2) of the tile, column 8*n + (lane%4)*2 + (e&1).
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 1)
prefill_tc_kernel(const bf16* __restrict__ q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const int* __restrict__ lengths, bf16* __restrict__ out,
                  int B, int Tn, int H, int Hkv, int ntiles,
                  float scale_log2) {
  constexpr int CH = DH / 8;            // 16-byte chunks per row
  constexpr int KS = DH / 16;           // k-steps of Q Kᵀ
  constexpr int NS = kN / 8;            // key columns of 8 in S
  constexpr int KV_BYTES = kN * DH * 2; // one K (or V) tile
  const float kInf = __int_as_float(0x7f800000);
  extern __shared__ uint4 smem_raw[];
  char* base = reinterpret_cast<char*>(smem_raw);
  base += (1024 - (smem_u32(base) & 1023)) & 1023;   // swizzle atoms align
  char* q_s = base;                     // [DH/64][kM][64]
  char* kv_s = q_s + kM * DH * 2;       // stage: K [DH/64][kN][64], then V
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + kStages * 2 * KV_BYTES);
  uint64_t* empty = full + kStages;

  const int per_tile = Hkv * B;
  const int tile = ntiles - 1 - (int)(blockIdx.x / per_tile);
  const int rem = (int)(blockIdx.x % per_tile);
  const int h = rem % Hkv, b = rem / Hkv;
  const int G = H / Hkv, rows = Tn * G;
  const int r0 = tile * kM;
  const int live = min(rows - r0, kM);
  const int len = min(max(lengths[b], 0), Tn);
  const int nkeys = min(len, (r0 + live - 1) / G + 1);
  const int nt = (nkeys + kN - 1) / kN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // q tile (rows past the last one: zeros), with K/V tile 0: group 0
  const bf16* qb = q + (int64_t)b * Tn * H * DH;
  for (int i = tid; i < kM * CH; i += kTcThreads) {
    const int rr = i / CH, c = i % CH, r = r0 + rr;
    const bool ok = rr < live;
    const bf16* src =
        ok ? qb + ((int64_t)(r / G) * H + h * G + r % G) * DH + c * 8 : q;
    cp_async16(q_s + swz<kM>(rr, c), src, ok);
  }
  cp_async_commit();
  // K/V tile j by TMA: boxes of 64 keys x 64 dims of kv head h, past T
  // zeros; issued by thread 0, landing on full[j % kStages]
  auto load_kv = [&](int j) {
    char* ks = kv_s + (j % kStages) * 2 * KV_BYTES;
    uint64_t* bar = full + j % kStages;
    mbar_expect(bar, 2 * KV_BYTES);
#pragma unroll
    for (int c = 0; c < DH / 64; ++c) {
      tma_load(ks + c * kN * 128, &map_k, bar, c * 64, h, j * kN, b);
      tma_load(ks + KV_BYTES + c * kN * 128, &map_v, bar, c * 64, h, j * kN,
               b);
    }
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

  const int ra = r0 + warp * 16 + (lane >> 2);   // this thread's two rows
  const int ta = ra / G, tb = (ra + 8) / G;      // and their tokens
  const int t_first = r0 / G;
  float o[DH / 2];                      // O: 64 rows x DH per warpgroup
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m0 = -kInf, m1 = -kInf, l0 = 0.f, l1 = 0.f;   // l: this lane's part
  // Q's A fragments of this warpgroup's rows, in registers for the walk
  // (only K is read from shared memory by the score products)
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], q_s + swz<kM>(warp * 16 + (lane & 7) +
                                      (((lane >> 3) & 1) << 3),
                                  kk * 2 + (lane >> 4)));

  // S = Q Kᵀ of tile j: 64 rows x kN keys for this warpgroup, issued async
  auto scores = [&](float (&sc)[NS * 4], int j) {
    const char* ks = kv_s + (j % kStages) * 2 * KV_BYTES;
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
  };

  // Softmax of tile j's scores (ops.py:_flash_block_update on raw scores,
  // m raw; p = 2^(s * scale * log2(e) - m * scale * log2(e))): P as bf16
  // hi and lo A fragments, and O's rescale (al0, al1) for P V.
  uint32_t ph[kN / 16][4], pl[kN / 16][4];
  float al0 = 0.f, al1 = 0.f;
  auto softmax = [&](float (&s)[NS * 4], int j) {
    const int j0 = j * kN;
    if (j0 + kN - 1 > t_first || j0 + kN > len) {   // mask crossing tiles
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + n * 8 + (lane & 3) * 2 + (e & 1);
          if (key > (e < 2 ? ta : tb) || key >= len) s[4 * n + e] = -kInf;
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
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], ph[kk][i],
               pl[kk][i]);
  };

  // O = O * 2^(m_old - m) + P V of tile j, issued async
  auto pv = [&](int j) {
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      o[4 * n] *= al0;
      o[4 * n + 1] *= al0;
      o[4 * n + 2] *= al1;
      o[4 * n + 3] *= al1;
    }
    const char* vs = kv_s + (j % kStages) * 2 * KV_BYTES + KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      const uint64_t bv = desc(vs + kk * 16 * 128, kN * 128, 1024);
      wgmma_pv<DH>(o, ph[kk], bv);
#if CONTIG_PREFILL_SPLIT_P
      wgmma_pv<DH>(o, pl[kk], bv);
#endif
    }
    wgmma_commit();
  };

  // Tile j landed, and (last tile) its V rows past the walk zeroed.
  auto arrived = [&](int j) {
    mbar_wait(full + j % kStages, (j / kStages) & 1);
    if (j == nt - 1 && nkeys % kN) {
      char* vs = kv_s + (j % kStages) * 2 * KV_BYTES + KV_BYTES;
      const int first = nkeys % kN;
      for (int i = tid; i < (kN - first) * (DH / 8); i += kTcThreads) {
        const int r = first + i % (kN - first), c = i / (kN - first);
        *reinterpret_cast<uint4*>(vs + swz<kN>(r, c)) =
            make_uint4(0, 0, 0, 0);
      }
      fence_async_smem();
      __syncthreads();                  // (both warpgroups, last tile only)
    }
  };

  // The walk. In step j a warpgroup issues Q K_{j+1}ᵀ, runs the softmax of
  // tile j on the CUDA cores while that product runs on the tensor cores,
  // then issues P_j V_j and waits for both (products left in flight across
  // steps, or accumulators touched between issues, make ptxas serialise
  // them). The two warpgroups are not tied by a barrier, so one's softmax
  // also runs under the other's products: each waits for tile j on
  // full[j % kStages] and releases the stage on empty after P_j V_j;
  // thread 0 copies tile j + 2 once both have released tile j - 2.
  float s[NS * 4], s_next[NS * 4];
  if (nt > 0) {
    arrived(0);
    scores(s, 0);
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
      scores(s_next, j + 1);
    }
    softmax(s, j);
    pv(j);
    wgmma_wait<0>();                    // P V of j and the scores of j + 1
    fence_regs(o);
    if ((tid & 127) == 0) mbar_arrive(empty + j % kStages);
    if (next) {
      fence_regs(s_next);
#pragma unroll
      for (int i = 0; i < NS * 4; ++i) s[i] = s_next[i];
    }
  }

  // ops.py:_flash_finish: acc / l, l == 0 -> 1
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ra + 8 * half;
    if (r - r0 >= live) continue;
    const int t = half ? tb : ta, g = r % G;
    const float inv = half ? inv1 : inv0;
    bf16* dst = out + (((int64_t)b * Tn + t) * H + h * G + g) * DH +
                (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
          o[4 * n + 2 * half] * inv, o[4 * n + 2 * half + 1] * inv);
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found at run time (no -lcuda).
EncodeTiled encode_tiled() {
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

// A 4-D map over k or v [B, T, Hkv, DH] (bf16) whose box is 64 keys x 64
// dims of one kv head, stored 128-byte swizzled: the wgmma operand layout.
int kv_map(CUtensorMap* map, const void* base, int B, int Tn, int Hkv,
           int DH) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)Hkv,
                              (cuuint64_t)Tn, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)DH * 2,
                                 (cuuint64_t)Hkv * DH * 2,
                                 (cuuint64_t)Tn * Hkv * DH * 2};
  const cuuint32_t box[4] = {64, 1, kN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* lengths, void* out, int B, int Tn, int H,
                int Hkv, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<DH>();
  CUtensorMap map_k, map_v;
  int rc = kv_map(&map_k, k, B, Tn, Hkv, DH);
  if (rc == 0) rc = kv_map(&map_v, v, B, Tn, Hkv, DH);
  if (rc != 0) return rc;
  const int G = H / Hkv;
  const int ntiles = (int)(((int64_t)Tn * G + kM - 1) / kM);
  const int64_t blocks = (int64_t)ntiles * Hkv * B;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      prefill_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  prefill_tc_kernel<DH><<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), map_k, map_v,
      static_cast<const int*>(lengths),
      static_cast<bf16*>(out), B, Tn, H, Hkv, ntiles,
      1.4426950408889634f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int repro_contiguous_prefill_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int Tn, int H, int Hkv, int Dh, int dtype,
    void* stream) {
  if (B <= 0 || Tn <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || B > 65535 || Hkv > 65535 ||
      (int64_t)Tn * H > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 128)
    return launch_f32<128>(q, k, v, lengths, out, B, Tn, H, Hkv, st);
  if (dtype == 0 && Dh == 64)
    return launch_f32<64>(q, k, v, lengths, out, B, Tn, H, Hkv, st);
  if (dtype == 1 && Dh == 128)
    return launch_bf16<128>(q, k, v, lengths, out, B, Tn, H, Hkv, st);
  if (dtype == 1 && Dh == 64)
    return launch_bf16<64>(q, k, v, lengths, out, B, Tn, H, Hkv, st);
  return (int)cudaErrorInvalidValue;
}
