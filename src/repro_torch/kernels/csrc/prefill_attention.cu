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
// What bounds it on an H100: a chunk of 256 tokens does 4*G*Dh flops per
// (token, visible key) against K/V read once, so long chunks are bound by
// the score and P*V products, which must run on the tensor cores.
//
// bf16: tc_walk.cuh's tensor-core walk (as the contiguous prefill runs it:
// TMA ring, wgmma, free-running warpgroups, P split into bf16 hi + lo).
// One block owns 128 query rows of one kv head of one chunk, row r being
// chunk token r / G and query head h*G + r % G; it walks the keys its rows
// can see (causal pruning: up to its last live row's position). K/V tiles
// of 64 keys come by TMA from a 4-D map over the pool whose box is
// min(BS, 64) positions x 64 dims of kv head h: thread 0 reads each table
// entry (from a copy of the table in shared memory) and issues
// 64 / min(BS, 64) boxes per 64 dims into one stage. The pool's maps are
// encoded once per (pool, shape) and kept. The 1-D grid
// runs heaviest row tiles first. It takes the block sizes that tile 64
// keys exactly (BS divides 64, or 64 divides BS: tcw::paged_tma_block):
// BS 16, the engine's default, among them.
//
// A second hand-written path, chosen by shape and never because of a
// failure: f32, and bf16 pools of any other block size (BS 6, say), run
// flash_core.cuh's CUDA-core walk (16 rows per block, 32-key f32 tiles,
// grid (row tile, kv head, chunk)). f32 exists to hold the function to
// 1e-4, which bf16 products cannot do.
//
// The grid needs no work list, so `num_work` is not taken.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libprefill_attention.so prefill_attention.cu
#include "flash_core.cuh"
#include "tc_walk.cuh"

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

// bf16 on the tensor cores: 1-D grid over (row tile, kv head, chunk),
// heaviest row tiles first.
template <int DH>
__global__ void __launch_bounds__(tcw::kThreads, 1)
chunk_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const int* __restrict__ block_tables,
                const int* __restrict__ ctx_lens,
                const int* __restrict__ chunk_lens,
                __nv_bfloat16* __restrict__ out, int B, int C, int H,
                int Hkv, int BS, int NBT, int ntiles, float scale_log2) {
  extern __shared__ uint4 smem_raw[];
  const int per_tile = Hkv * B;
  const int tile = ntiles - 1 - (int)(blockIdx.x / per_tile);
  const int rem = (int)(blockIdx.x % per_tile);
  const int h = rem % Hkv, b = rem / Hkv;
  const int G = H / Hkv, r0 = tile * tcw::kM;
  const int ctx = ctx_lens[b], clen = chunk_lens[b], total = ctx + clen;
  const int live_rows = total <= 0 ? 0 : max(0, min(clen, C)) * G;
  const tcw::Rows rw{r0, max(0, min(live_rows - r0, tcw::kM)),
                     min(C * G - r0, tcw::kM), ctx, total};
  const int64_t seg = (int64_t)b * C * H * DH;
  tcw::walk_tma<DH>(
      q + seg, out + seg,
      tcw::PagedSrc{&map_k, &map_v, block_tables + (int64_t)b * NBT, BS, h},
      rw, h, H, G, scale_log2, reinterpret_cast<char*>(smem_raw));
}

template <int DH>
int launch_tc(const void* q, const void* k_pool, const void* v_pool,
              const void* block_tables, const void* ctx_lens,
              const void* chunk_lens, void* out, int B, int C, int H,
              int Hkv, int BS, int NBT, int NB, cudaStream_t stream) {
  const int smem = tcw::tma_smem_bytes<DH>(NBT);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  CUtensorMap map_k, map_v;
  int rc = tcw::pool_map(&map_k, k_pool, NB, BS, Hkv, DH);
  if (rc == 0) rc = tcw::pool_map(&map_v, v_pool, NB, BS, Hkv, DH);
  if (rc != 0) return rc;
  const int G = H / Hkv;
  const int ntiles = (int)(((int64_t)C * G + tcw::kM - 1) / tcw::kM);
  const int64_t blocks = (int64_t)ntiles * Hkv * B;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  static int smem_set = 0;                  // the attribute, once per size
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  chunk_tc_kernel<DH><<<(unsigned)blocks, tcw::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), map_k, map_v,
      static_cast<const int*>(block_tables),
      static_cast<const int*>(ctx_lens), static_cast<const int*>(chunk_lens),
      static_cast<__nv_bfloat16*>(out), B, C, H, Hkv, BS, NBT, ntiles,
      1.4426950408889634f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. NB: blocks in the pool. Returns a
// cudaError_t (0 = launched).
extern "C" int repro_paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* ctx_lens, const void* chunk_lens,
    void* out, int B, int C, int H, int Hkv, int Dh, int BS, int NBT, int NB,
    int dtype, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || BS <= 0 || NBT <= 0 || NB <= 0 ||
      B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tc = dtype == 1 && tcw::paged_tma_block(BS);
  if (tc && Dh == 128)
    return launch_tc<128>(q, k_pool, v_pool, block_tables, ctx_lens,
                          chunk_lens, out, B, C, H, Hkv, BS, NBT, NB, st);
  if (tc && Dh == 64)
    return launch_tc<64>(q, k_pool, v_pool, block_tables, ctx_lens,
                         chunk_lens, out, B, C, H, Hkv, BS, NBT, NB, st);
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
