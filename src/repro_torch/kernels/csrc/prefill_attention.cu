// Chunked causal prefill attention over the paged pool for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/prefill_attention.py::
// paged_prefill_attention (body `_paged_prefill_kernel`): B prompt chunks of
// C query tokens; query row i of chunk b (global position ctx_b + i) attends
// keys idx < ctx_b + clen_b and idx <= ctx_b + i, read from the pool
// [NB, BS, Hkv, Dh] through the chunk's block table. The chunk's own K/V are
// already in the pool. Rows i >= clen_b are padding: the TPU leaves them
// garbage, this kernel writes zeros.
//
// Recast for a machine whose blocks run in parallel. The TPU walks a flat
// (chunk, logical block) work list in order and carries (m, l, acc) in
// scratch; here one thread block owns (chunk, kv head, tile of 16 query
// rows), walks the keys its rows can see (causal pruning: up to the tile's
// largest query position) and keeps m, l, acc in f32 registers
// (flash_core.cuh). Query row r of kv head h is chunk token r / G, query
// head h*G + r % G. The grid needs no work list, so `num_work` is not taken.
//
// What bounds it on an H100: a chunk of 256 tokens does 4*G*Dh flops per
// (token, visible key) against K/V read once per tile, so long chunks are
// bound by the score and P*V products. This version does them in f32 on the
// CUDA cores, each block walking its keys serially: latency, not peak
// throughput, sets its time. Tensor cores (wgmma) and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprefill_attention.so prefill_attention.cu
#include "flash_core.cuh"

namespace {

using namespace flash;

constexpr int kRowsPerThread = kTileRows / kRowGroups;   // 2

// Grid (row tile, kv head, chunk).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                     const T* __restrict__ v_pool,
                     const int* __restrict__ block_tables,
                     const int* __restrict__ ctx_lens,
                     const int* __restrict__ chunk_lens, T* __restrict__ out,
                     int C, int H, int Hkv, int BS, int NBT, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int r0 = tile * kTileRows;
  const int ctx = ctx_lens[b];
  const int total = ctx + chunk_lens[b];
  const int live_rows = total <= 0 ? 0 : min(chunk_lens[b], C) * G;
  const int tile_live = max(0, min(live_rows - r0, kTileRows));
  const int nkeys =
      tile_live == 0 ? 0 : min(total, ctx + (r0 + tile_live - 1) / G + 1);
  const int64_t seg = (int64_t)b * C * H * DH;
  Rows<DH, kRowsPerThread> st;
  attend<T, DH, kRowsPerThread>(st, q + seg, k_pool, v_pool,
                                PagedKeys{block_tables + (int64_t)b * NBT, BS},
                                smem, h, r0, tile_live, 0, nkeys, nkeys, true,
                                ctx, total, H, Hkv, scale);
  finish<T, DH, kRowsPerThread>(st, out + seg, h, r0, C * G, H, Hkv);
}

template <typename T, int DH>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_tables, const void* ctx_lens,
           const void* chunk_lens, void* out, int B, int C, int H, int Hkv,
           int BS, int NBT, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DH>();
  static_assert(smem <= 48 * 1024, "tile needs the opt-in smem attribute");
  const int G = H / Hkv;
  dim3 grid((C * G + kTileRows - 1) / kTileRows, Hkv, B);
  paged_prefill_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(ctx_lens), static_cast<const int*>(chunk_lens),
      static_cast<T*>(out), C, H, Hkv, BS, NBT, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int repro_paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* ctx_lens, const void* chunk_lens,
    void* out, int B, int C, int H, int Hkv, int Dh, int BS, int NBT,
    int dtype, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || BS <= 0 || NBT <= 0 || B > 65535 ||
      Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 128)
    return launch<float, 128>(q, k_pool, v_pool, block_tables, ctx_lens,
                              chunk_lens, out, B, C, H, Hkv, BS, NBT, st);
  if (dtype == 0 && Dh == 64)
    return launch<float, 64>(q, k_pool, v_pool, block_tables, ctx_lens,
                             chunk_lens, out, B, C, H, Hkv, BS, NBT, st);
  if (dtype == 1 && Dh == 128)
    return launch<__nv_bfloat16, 128>(q, k_pool, v_pool, block_tables,
                                      ctx_lens, chunk_lens, out, B, C, H, Hkv,
                                      BS, NBT, st);
  if (dtype == 1 && Dh == 64)
    return launch<__nv_bfloat16, 64>(q, k_pool, v_pool, block_tables,
                                     ctx_lens, chunk_lens, out, B, C, H, Hkv,
                                     BS, NBT, st);
  return (int)cudaErrorInvalidValue;
}
