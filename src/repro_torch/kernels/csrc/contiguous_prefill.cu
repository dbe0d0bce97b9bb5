// Causal flash prefill over contiguous caches for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/prefill_attention.py::
// prefill_attention (body `_prefill_kernel`): causal GQA of q [B, T, H, Dh]
// against k, v [B, T, Hkv, Dh] with per-row lengths (clamped to T). Key s is
// visible to query t iff s <= t and s < length; a row that sees no key (a
// length-0 row) writes zeros. Rows t >= length still attend their first
// `length` keys, as on the TPU.
//
// Recast for parallel blocks. The TPU's grid (B, Hkv, T/256, T/256) carries
// m, l, acc across its innermost kv-block dimension and skips (q tile, kv
// tile) pairs past the diagonal or past the length (causal block pruning).
// Here one thread block owns (row tile of 16 query rows of one kv head, kv
// head, batch row): it walks only the keys its rows can see -- up to its last
// row's position and below the length -- in flash_core.cuh's 32-key tiles,
// so the pruned pairs are never read, and keeps m, l, acc in f32 registers.
// Query row r of kv head h is token r / G, query head h*G + r % G. The
// TPU's 256-row tiles only change the summation order.
//
// What bounds it on an H100: 4*Dh flops per (query head, visible key) against
// K/V read once per row tile; a long prompt is bound by those products (about
// 2*T*G flops a byte of K/V at T tokens). This version does them in f32 on
// the CUDA cores, each block walking its keys serially: latency, not peak
// throughput, sets its time, as in prefill_attention.cu. Tensor cores
// (wgmma) and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcontiguous_prefill.so contiguous_prefill.cu
#include "flash_core.cuh"

namespace {

using namespace flash;

constexpr int kRowsPerThread = kTileRows / kRowGroups;   // 2

// Grid (row tile, kv head, batch row).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
contiguous_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ lengths,
                          T* __restrict__ out, int Tn, int H, int Hkv,
                          float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int r0 = tile * kTileRows;
  const int len = min(max(lengths[b], 0), Tn);
  const int tile_live = max(0, min(Tn * G - r0, kTileRows));
  // causal pruning: the tile's last row sees keys up to its own position
  const int nkeys = tile_live == 0 ? 0
                                   : min(len, (r0 + tile_live - 1) / G + 1);
  const int64_t seg = (int64_t)b * Tn * H * DH;
  Rows<DH, kRowsPerThread> st;
  attend<T, DH, kRowsPerThread>(st, q + seg, k, v,
                                ContigKeys{(int64_t)b * Tn}, smem, h, r0,
                                tile_live, 0, nkeys, nkeys, true, 0, len, H,
                                Hkv, scale);
  finish<T, DH, kRowsPerThread>(st, out + seg, h, r0, Tn * G, H, Hkv);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int Tn, int H, int Hkv, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DH>();
  static_assert(smem <= 48 * 1024, "tile needs the opt-in smem attribute");
  const int G = H / Hkv;
  const dim3 grid((Tn * G + kTileRows - 1) / kTileRows, Hkv, B);
  contiguous_prefill_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), Tn, H, Hkv, 1.0f / sqrtf((float)DH));
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
    return launch<float, 128>(q, k, v, lengths, out, B, Tn, H, Hkv, st);
  if (dtype == 0 && Dh == 64)
    return launch<float, 64>(q, k, v, lengths, out, B, Tn, H, Hkv, st);
  if (dtype == 1 && Dh == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, lengths, out, B, Tn, H, Hkv,
                                      st);
  if (dtype == 1 && Dh == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, lengths, out, B, Tn, H, Hkv,
                                     st);
  return (int)cudaErrorInvalidValue;
}
