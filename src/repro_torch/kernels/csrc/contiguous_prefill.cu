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
// bf16: tc_walk.cuh's tensor-core walk (TMA ring, wgmma, free-running
// warpgroups, P split into bf16 hi + lo), one block per tile of 128 query
// rows of one kv head, fed by one TMA box of 64 keys per 64 dims from a
// 4-D tensor map over [B, T, Hkv, Dh] (keys past T arrive as zeros).
// Blocks run heaviest row tile first, so the causal tail of the grid is
// short. tools/profile_torch_prefill_split.py builds the single-product
// variant (TC_WALK_SPLIT_P=0) and compares.
//
// f32: a second hand-written path, not a fallback: flash_core.cuh's
// CUDA-core walk (16 rows per block, 32-key f32 tiles). f32 exists to hold
// the function to 1e-4, which TF32 or bf16 products cannot do.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcontiguous_prefill.so contiguous_prefill.cu
#include "flash_core.cuh"
#include "tc_walk.cuh"

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

// 1-D grid over (row tile, kv head, batch row), heaviest row tiles first.
template <int DH>
__global__ void __launch_bounds__(tcw::kThreads, 1)
prefill_tc_kernel(const bf16* __restrict__ q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const int* __restrict__ lengths, bf16* __restrict__ out,
                  int B, int Tn, int H, int Hkv, int ntiles,
                  float scale_log2) {
  extern __shared__ uint4 smem_raw[];
  const int per_tile = Hkv * B;
  const int tile = ntiles - 1 - (int)(blockIdx.x / per_tile);
  const int rem = (int)(blockIdx.x % per_tile);
  const int h = rem % Hkv, b = rem / Hkv;
  const int G = H / Hkv, r0 = tile * tcw::kM;
  const int live = min(Tn * G - r0, tcw::kM);
  const int len = min(max(lengths[b], 0), Tn);
  const int64_t seg = (int64_t)b * Tn * H * DH;
  tcw::walk_tma<DH>(q + seg, out + seg, tcw::ContigSrc{&map_k, &map_v, h, b},
                    tcw::Rows{r0, live, live, 0, len}, h, H, G, scale_log2,
                    reinterpret_cast<char*>(smem_raw));
}

// A 4-D map over k or v [B, T, Hkv, DH] (bf16) whose box is 64 keys x 64
// dims of one kv head, stored 128-byte swizzled: the wgmma operand layout.
int kv_map(CUtensorMap* map, const void* base, int B, int Tn, int Hkv,
           int DH) {
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)Hkv,
                              (cuuint64_t)Tn, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)DH * 2,
                                 (cuuint64_t)Hkv * DH * 2,
                                 (cuuint64_t)Tn * Hkv * DH * 2};
  const cuuint32_t box[4] = {64, 1, tcw::kN, 1};
  return tcw::bf16_map(map, base, dims, strides, box);
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* lengths, void* out, int B, int Tn, int H,
                int Hkv, cudaStream_t stream) {
  constexpr int smem = tcw::tma_smem_bytes<DH>();
  CUtensorMap map_k, map_v;
  int rc = kv_map(&map_k, k, B, Tn, Hkv, DH);
  if (rc == 0) rc = kv_map(&map_v, v, B, Tn, Hkv, DH);
  if (rc != 0) return rc;
  const int G = H / Hkv;
  const int ntiles = (int)(((int64_t)Tn * G + tcw::kM - 1) / tcw::kM);
  const int64_t blocks = (int64_t)ntiles * Hkv * B;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      prefill_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  prefill_tc_kernel<DH><<<(unsigned)blocks, tcw::kThreads, smem, stream>>>(
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
