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
//     score at -1e30, so each computed key weighs exp(0) = 1 and the row is
//     the mean of V over the nj * block_s padded rows, zero rows included --
//     the TPU kernel's result, reproduced here.
//   ragged (ragged = 1): blocks that start at or past the length are skipped,
//     so the cost is sum_b ceil(L_b/block_s) blocks; a length-0 row computes
//     nothing and writes zeros.
// Either way a computed block is computed whole, its keys past the length
// masked: `block_s` decides which keys are computed, as on the TPU, and is
// not the shared-memory tile (512 bf16 rows of Dh 128 are 128 KB a side).
//
// What bounds it on an H100: each computed key costs 4*G*Dh flops against
// its 4*Dh bytes of K and V (bf16), about G flops a byte, so the bytes read
// bind it -- the whole cache in padded mode (20.97 GB at Fig. 2's 200v10000
// batch: 6.26 ms at 3.35 TB/s), the computed blocks in ragged mode. The card
// streams at that rate only with many bytes in flight on every SM, and
// only if the math keeps up with the copies.
//
// What the design does about it: split_decode.cuh's tile (one warpgroup a
// block), on the grid (split, kv head, request). Split s walks keys [s*K,
// min((s+1)*K, end)) of the row's computed range [0, end) through a 3-stage
// cp.async ring (2 tiles of 32 keys in flight per block), the G rows in a
// compile-time tile of 4, 8 or 16 so no loop branches on G. Three stages, not
// the tile's default four, so that four blocks fit an SM (bf16, Dh 128, G <=
// 4: 55 KB each) instead of three: on an H100 SXM at 700 W the copies alone
// stream ~3.05 TB/s either way, and the fourth block is what hides the math
// behind them (PERF.md §6). Keys at or past S load as zeros, keys at or past
// the length score the finite -1e30 and every walked key counts, so a padded
// length-0 row comes out as the TPU's mean. The split plan comes from host
// shapes (decode_attention.py::contiguous_split_plan): one split per (request,
// kv head) once B * Hkv blocks fill the blocks the card holds at once -- Fig.
// 2's 4096 and 1024 do, so no partials and no merge -- and otherwise as many
// splits as fill that one wave, merged by the last to arrive. The padded mode
// still reads and computes every block: skipping them would make it the ragged
// mode.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcontiguous_decode.so contiguous_decode.cu
#include "split_decode.cuh"

namespace {

constexpr int kStages = 3;                  // ring depth: 4 blocks an SM

// Grid (split, kv head, request): a request's splits are dispatched
// together. Partials [B, Hkv, splits, G] when splits > 1.
template <typename T, int DH, int NR>
__global__ void __launch_bounds__(sdec::kThreads)
contiguous_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths,
                        const int* __restrict__ kv_rows,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml,
                        int* __restrict__ arrivals,
                        T* __restrict__ out, int S, int H, int Hkv,
                        int block_s, int nj, int ragged, int split_keys,
                        float scale_log2) {
  extern __shared__ uint4 smem_raw[];
  __shared__ int last;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z, G = H / Hkv;
  const int len = max(lengths[b], 0);
  const int blocks =
      ragged ? min(nj, len / block_s + (len % block_s != 0)) : nj;
  const int end = blocks * block_s;         // the computed keys
  T* out_bh = out + ((int64_t)b * H + h * G) * DH;
  if (end == 0) {                           // ragged, length 0: zeros
    if (s == 0)
      for (int x = threadIdx.x; x < G * DH; x += sdec::kThreads)
        flash::store1(out_bh + x, 0.f);
    return;
  }
  const int k_lo = s * split_keys;
  if (k_lo >= end) return;                  // nothing computed: not counted
  const int n = min(split_keys, end - k_lo);
  const sdec::Span span{n, max(0, min(S - k_lo, n)),
                        max(0, min(len - k_lo, n))};
  sdec::attend<T, T, DH, NR, false, kStages>(
      q + ((int64_t)b * H + h * G) * DH, k, v, nullptr, nullptr,
      sdec::ContigKeys{(int64_t)(kv_rows ? kv_rows[b] : b) * S + k_lo}, span,
      G, Hkv, h, scale_log2,
      sdec::SplitSlots{((int64_t)b * Hkv + h) * gridDim.x * G, G}, s,
      1 + (end - 1) / split_keys, part_acc, part_ml,
      arrivals + (int64_t)b * Hkv + h, out_bh,
      reinterpret_cast<char*>(smem_raw), &last, threadIdx.x, 0);
}

template <typename T, int DH, int NR>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* kv_rows, void* part_acc, void* part_ml,
           void* arrivals, void* out, int B, int S, int H, int Hkv,
           int block_s, int ragged, int splits, int split_keys,
           cudaStream_t stream) {
  constexpr int smem = sdec::Tile<T, DH, NR, false, kStages>::SMEM;
  static_assert(smem <= 227 * 1024, "tile exceeds shared memory");
  static bool smem_set = false;             // the attribute, once
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        contiguous_split_kernel<T, DH, NR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  contiguous_split_kernel<T, DH, NR>
      <<<dim3(splits, Hkv, B), sdec::kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(lengths),
          static_cast<const int*>(kv_rows), static_cast<float*>(part_acc),
          static_cast<float*>(part_ml), static_cast<int*>(arrivals),
          static_cast<T*>(out), S, H, Hkv,
          block_s, (S + block_s - 1) / block_s, ragged, split_keys,
          1.4426950408889634f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_rows(const void* q, const void* k, const void* v,
                const void* lengths, const void* kv_rows, void* part_acc,
                void* part_ml, void* arrivals, void* out, int B, int S, int H,
                int Hkv, int block_s, int ragged, int splits, int split_keys,
                cudaStream_t stream) {
  const int G = H / Hkv;
  if (G <= 4)
    return launch<T, DH, 4>(q, k, v, lengths, kv_rows, part_acc, part_ml,
                            arrivals, out, B, S, H, Hkv, block_s, ragged,
                            splits, split_keys, stream);
  if (G <= 8)
    return launch<T, DH, 8>(q, k, v, lengths, kv_rows, part_acc, part_ml,
                            arrivals, out, B, S, H, Hkv, block_s, ragged,
                            splits, split_keys, stream);
  return launch<T, DH, sdec::kMaxG>(q, k, v, lengths, kv_rows, part_acc,
                                    part_ml, arrivals, out, B, S, H, Hkv,
                                    block_s, ragged, splits, split_keys,
                                    stream);
}

}  // namespace

// kv_rows: null, or [B] int32 cache rows, query row b reading the keys of
// cache row kv_rows[b] (k, v then hold any number of rows of S keys: a
// serving slab whose live rows decode without a gather); the caller keeps
// each in range. block_s: already clamped to S by the caller. splits,
// split_keys: the split plan (decode_attention.py::contiguous_split_plan),
// covering the nj*block_s padded keys; with splits > 1, part_acc holds
// B*Hkv*splits*G*Dh floats, part_ml B*Hkv*splits*G*2 and arrivals B*Hkv ints,
// all 0, left all 0 (the caller keeps them for the next call on the same
// stream). dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 =
// launched).
extern "C" int repro_contiguous_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* kv_rows, void* part_acc, void* part_ml, void* arrivals,
    void* out, int B, int S, int H, int Hkv, int Dh, int block_s, int ragged,
    int splits, int split_keys, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (S <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > sdec::kMaxG ||
      block_s <= 0 || block_s > S || Hkv > 65535 || B > 65535 ||
      (int64_t)S + block_s > INT32_MAX || splits <= 0 ||
      splits > sdec::kMaxSplits || split_keys <= 0 ||
      (int64_t)splits * split_keys > INT32_MAX ||
      (int64_t)splits * split_keys <
          (int64_t)((S + block_s - 1) / block_s) * block_s ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr ||
                      arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 128)
    return launch_rows<float, 128>(q, k, v, lengths, kv_rows, part_acc,
                                   part_ml, arrivals, out, B, S, H, Hkv,
                                   block_s, ragged, splits, split_keys, st);
  if (dtype == 0 && Dh == 64)
    return launch_rows<float, 64>(q, k, v, lengths, kv_rows, part_acc,
                                  part_ml, arrivals, out, B, S, H, Hkv,
                                  block_s, ragged, splits, split_keys, st);
  if (dtype == 1 && Dh == 128)
    return launch_rows<__nv_bfloat16, 128>(q, k, v, lengths, kv_rows,
                                           part_acc, part_ml, arrivals, out,
                                           B, S, H, Hkv, block_s, ragged,
                                           splits, split_keys, st);
  if (dtype == 1 && Dh == 64)
    return launch_rows<__nv_bfloat16, 64>(q, k, v, lengths, kv_rows,
                                          part_acc, part_ml, arrivals, out,
                                          B, S, H, Hkv, block_s, ragged,
                                          splits, split_keys, st);
  return (int)cudaErrorInvalidValue;
}
