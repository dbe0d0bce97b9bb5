// Flash-decode GQA attention over contiguous caches for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (body `_decode_kernel`): one query token per request, q [B, H, Dh], against
// its cache k, v [B, S, Hkv, Dh], lengths [B]; query head h reads kv head
// h / G. The cache is cut into blocks of `block_s` keys (clamped to S, the
// tail padded with zero rows up to nj = ceil(S/block_s) whole blocks).
//   padded (ragged = 0): every block is computed, keys idx >= length masked,
//     so the cost is B * nj blocks whatever the lengths: the paper's baseline
//     whose heterogeneity tax its Fig. 2 measures. A length-0 row sees every
//     score at -1e30, so each walked key weighs exp(0) = 1 and the row is the
//     mean of V over the nj * block_s padded rows, zero rows included -- the
//     TPU kernel's result, reproduced here (kExpMasked in flash_core.cuh).
//   ragged (ragged = 1): blocks that start at or past the length are skipped,
//     so the cost is sum_b ceil(L_b/block_s) blocks; a length-0 row walks
//     nothing and writes zeros.
// Either way a computed block is computed whole, its keys past the length
// masked: `block_s` decides which keys are computed, as on the TPU, and is
// not the shared-memory tile (512 bf16 rows of Dh 128 are 128 KB a side).
//
// Recast for parallel blocks: one thread block owns (request, kv head) and
// walks its computed keys in flash_core.cuh's 32-key tiles, in order, with m,
// l and acc in f32 registers; keys at or past S load as zeros, never read.
//
// What bounds it on an H100: each computed key costs 4*G*Dh flops against
// its 4*Dh bytes of K and V (bf16), about G flops a byte, so the bytes read
// bind it -- all of the cache in padded mode, the computed blocks in ragged
// mode. The design keeps every byte it reads at a 16-byte coalesced load and
// reads each once; B * Hkv blocks (4096 at the Fig. 2 batch) fill the card.
// Split-KV for small batches and tensor cores are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcontiguous_decode.so contiguous_decode.cu
#include "flash_core.cuh"

namespace {

using namespace flash;

// Grid (request, kv head).
template <typename T, int DH, int RPT>
__global__ void __launch_bounds__(kThreads)
contiguous_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         int S, int H, int Hkv, int block_s, int nj,
                         int ragged, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x, h = blockIdx.y, G = H / Hkv;
  const int len = max(lengths[b], 0);
  const int blocks =
      ragged ? min(nj, len / block_s + (len % block_s != 0)) : nj;
  Rows<DH, RPT> st;
  attend<T, DH, RPT, true>(st, q + (int64_t)b * H * DH, k, v,
                           ContigKeys{(int64_t)b * S}, smem, h, 0, G, 0,
                           blocks * block_s, S, false, 0, len, H, Hkv, scale);
  finish<T, DH, RPT>(st, out + (int64_t)b * H * DH, h, 0, G, H, Hkv);
}

template <typename T, int DH, int RPT>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int S, int H, int Hkv, int block_s, int ragged,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<DH>();
  static_assert(smem <= 48 * 1024, "tile needs the opt-in smem attribute");
  const int nj = (S + block_s - 1) / block_s;
  contiguous_decode_kernel<T, DH, RPT>
      <<<dim3(B, Hkv), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(lengths),
          static_cast<T*>(out), S, H, Hkv, block_s, nj, ragged,
          1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_rows(int G, const void* q, const void* k, const void* v,
                const void* lengths, void* out, int B, int S, int H, int Hkv,
                int block_s, int ragged, cudaStream_t stream) {
  if (G <= kRowGroups)
    return launch<T, DH, 1>(q, k, v, lengths, out, B, S, H, Hkv, block_s,
                            ragged, stream);
  return launch<T, DH, 2>(q, k, v, lengths, out, B, S, H, Hkv, block_s,
                          ragged, stream);
}

}  // namespace

// block_s: already clamped to S by the caller. dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int repro_contiguous_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int S, int H, int Hkv, int Dh, int block_s, int ragged,
    int dtype, void* stream) {
  if (B <= 0) return 0;
  if (S <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > flash::kTileRows ||
      block_s <= 0 || block_s > S || Hkv > 65535 ||
      (int64_t)S + block_s > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 128)
    return launch_rows<float, 128>(G, q, k, v, lengths, out, B, S, H, Hkv,
                                   block_s, ragged, st);
  if (dtype == 0 && Dh == 64)
    return launch_rows<float, 64>(G, q, k, v, lengths, out, B, S, H, Hkv,
                                  block_s, ragged, st);
  if (dtype == 1 && Dh == 128)
    return launch_rows<__nv_bfloat16, 128>(G, q, k, v, lengths, out, B, S, H,
                                           Hkv, block_s, ragged, st);
  if (dtype == 1 && Dh == 64)
    return launch_rows<__nv_bfloat16, 64>(G, q, k, v, lengths, out, B, S, H,
                                          Hkv, block_s, ragged, st);
  return (int)cudaErrorInvalidValue;
}
