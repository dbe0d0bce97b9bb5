// Paged decode attention for Hopper (sm_90a): the flat work-list kernel of
// the `flat` backend and the split-KV grid kernel of `grid`, both on
// split_decode.cuh's tile.
//
// ---- flat ----
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// paged_decode_attention_flat (body `_flat_paged_kernel`): GQA attention of
// one query token per request over its cache in the paged pool
// [NB, BS, Hkv, Dh], lengths = pos + 1 (0 = dead slot), driven by the flat
// (request, logical block) work list of kernels/ops.py::flat_work_list,
// which every layer of a decode forward shares.
//
// What bounds it on an H100: every live K/V byte is read once and each key
// costs 4*G*Dh flops, far below the ~295 flops/byte where the tensor cores
// would bind, so the bytes of K/V read -- a few MB a layer, a few µs at
// 3.35 TB/s. At that size what the card loses is latency: serial tile
// walks with their loads exposed, and launches.
//
// What the design does about it. The TPU walks the work list in order and
// carries (m, l, acc) from item to item. Here the list is cut into runs of
// `ipr` consecutive items (decode_attention.py::ITEMS_PER_RUN), one block
// of one warpgroup per (run, kv head), so a request gets blocks in
// proportion to its length and one long row fills the card. For each
// request its run holds, the block walks that request's keys [k_lo, k_hi)
// on split_decode.cuh's tile: a 4-stage cp.async ring of 32-key tiles, the
// G rows in a compile-time tile of 4, 8 or 16. Items are request-major with
// blocks in order, so an item's block index gives the request's first item
// (w - blk) and its item count (ceil(len/BS)) without a scan: a request
// within one run writes acc / l at once; a request over several runs makes
// one part at its first item and one at each run start inside its items,
// each counted in the (request, kv head)'s arrival count, and the last to
// arrive merges them in item order. One launch in all. Padding items
// (block index NBT, aliasing the last request with work) fail the
// start < length guard and do nothing; block (x, h) writes zeros for the
// dead slots b = x, x + runs, ... (the TPU leaves them unwritten). Sums run
// in another order than the TPU's sequential walk: run by run, then merged.
//
// ---- grid ----
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// paged_decode_attention (body `_paged_decode_kernel`): the same function on
// the (B, Hkv, NBT) grid. The TPU runs that grid in order on one core and
// skips the MXU work of blocks at or past a request's length. A length-0
// row writes zeros (_flash_finish's l = 0 -> 1).
//
// What bounds it on an H100: about 3 flops per byte of bf16 K/V, so the
// bytes of K/V read, and the card reaches its 3.35 TB/s only with several MB
// in flight over many blocks. One block per (request, kv head) walking one
// tile at a time gave 40 blocks at llama3.2-3b's heads and a serial walk
// of hundreds of tiles for one long row, each tile's memory latency exposed.
//
// Split-KV (split_decode.cuh's tile, one warpgroup a block). The grid is
// (split, kv head, request): split s walks table entries
// [s*P, min((s+1)*P, ceil(L_b/BS))), with S and P chosen on the host from
// B-independent shapes and the SM count (decode_attention.py::
// grid_split_plan) so that one long row alone gives ~2 blocks per SM; a
// request's splits are dispatched together. A split that starts at or past
// the length exits at once, so no table entry past ceil(L_b/BS) is read
// (the reference pads tables with block 0, the engine with its garbage
// block). The tile's header gives its copies (a 4-stage cp.async ring of
// 32-key tiles), its math (f32, rows in tiles of 4, 8 or 16) and its merge
// (folded into the last split to arrive, one launch in all). Sums run in
// another order than the TPU's sequential walk: split by split, then
// merged.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdecode_attention.so decode_attention.cu
#include "split_decode.cuh"

namespace {

using sdec::kMaxG;
using sdec::kMaxSplits;

// Where part j of request b keeps its partials [W, Hkv, G]: part 0 at the
// request's first item, part j > 0 at the start of the j-th run after the
// one that holds it.
struct FlatSlots {
  int first, run0, ipr, Hkv, h, G;
  __device__ __forceinline__ int64_t operator()(int j) const {
    const int w = j == 0 ? first : run0 + j * ipr;
    return ((int64_t)w * Hkv + h) * G;
  }
};

// Grid (run, kv head).
template <typename T, int DH, int NR>
__global__ void __launch_bounds__(sdec::kThreads)
flat_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int* __restrict__ block_tables,
                  const int* __restrict__ lengths,
                  const int* __restrict__ work_req,
                  const int* __restrict__ work_blk,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int* __restrict__ arrivals, T* __restrict__ out, int B,
                  int H, int Hkv, int BS, int NBT, int W, int ipr,
                  float scale_log2) {
  extern __shared__ uint4 smem_raw[];
  __shared__ int last;
  const int run = blockIdx.x, h = blockIdx.y, G = H / Hkv;
  for (int b = run; b < B; b += gridDim.x)  // dead slots: zeros
    if (lengths[b] <= 0)
      for (int x = threadIdx.x; x < G * DH; x += sdec::kThreads)
        flash::store1(out + ((int64_t)b * H + h * G) * DH + x, 0.f);
  const int w_end = min(run * ipr + ipr, W);
  for (int w = run * ipr; w < w_end;) {
    const int b = work_req[w], blk = work_blk[w], len = lengths[b];
    if (blk * BS >= len) {                  // padding: the TPU's length guard
      ++w;
      continue;
    }
    const int first = w - blk;              // the request's items [first, end)
    const int end = first + (len + BS - 1) / BS;
    const int w2 = min(w_end, end);         // this run's items of it
    const int k_lo = blk * BS;
    const int n = min((blk + w2 - w) * BS, len) - k_lo;
    T* out_bh = out + ((int64_t)b * H + h * G) * DH;
    sdec::attend<T, T, DH, NR, false>(
        q + ((int64_t)b * H + h * G) * DH, k_pool, v_pool, nullptr, nullptr,
        sdec::TableKeys{block_tables + (int64_t)b * NBT + blk, BS},
        sdec::Span{n, n, n}, G, Hkv, h, scale_log2,
        FlatSlots{first, first / ipr * ipr, ipr, Hkv, h, G},
        w / ipr - first / ipr, (end - 1) / ipr - first / ipr + 1, part_acc,
        part_ml, arrivals + (int64_t)b * Hkv + h, out_bh,
        reinterpret_cast<char*>(smem_raw), &last, threadIdx.x, 0);
    w = w2;
  }
}

template <typename T, int DH, int NR>
int launch_flat(const void* q, const void* k_pool, const void* v_pool,
                const void* block_tables, const void* lengths,
                const void* work_req, const void* work_blk, void* part_acc,
                void* part_ml, void* arrivals, void* out, int B, int H,
                int Hkv, int BS, int NBT, int W, int ipr,
                cudaStream_t stream) {
  const int smem = sdec::Tile<T, DH, NR, false>::bytes(ipr * BS);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  static int smem_set = 0;                  // the attribute, once per size
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flat_split_kernel<T, DH, NR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  flat_split_kernel<T, DH, NR>
      <<<dim3((W + ipr - 1) / ipr, Hkv), sdec::kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pool),
          static_cast<const T*>(v_pool),
          static_cast<const int*>(block_tables),
          static_cast<const int*>(lengths), static_cast<const int*>(work_req),
          static_cast<const int*>(work_blk), static_cast<float*>(part_acc),
          static_cast<float*>(part_ml), static_cast<int*>(arrivals),
          static_cast<T*>(out), B, H, Hkv, BS, NBT, W, ipr,
          1.4426950408889634f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_flat_rows(const void* q, const void* k_pool, const void* v_pool,
                     const void* block_tables, const void* lengths,
                     const void* work_req, const void* work_blk,
                     void* part_acc, void* part_ml, void* arrivals, void* out,
                     int B, int H, int Hkv, int BS, int NBT, int W, int ipr,
                     cudaStream_t stream) {
  const int G = H / Hkv;
  if (G <= 4)
    return launch_flat<T, DH, 4>(q, k_pool, v_pool, block_tables, lengths,
                                 work_req, work_blk, part_acc, part_ml,
                                 arrivals, out, B, H, Hkv, BS, NBT, W, ipr,
                                 stream);
  if (G <= 8)
    return launch_flat<T, DH, 8>(q, k_pool, v_pool, block_tables, lengths,
                                 work_req, work_blk, part_acc, part_ml,
                                 arrivals, out, B, H, Hkv, BS, NBT, W, ipr,
                                 stream);
  return launch_flat<T, DH, kMaxG>(q, k_pool, v_pool, block_tables, lengths,
                                   work_req, work_blk, part_acc, part_ml,
                                   arrivals, out, B, H, Hkv, BS, NBT, W, ipr,
                                   stream);
}

// ---- grid: split-KV (split_decode.cuh) ----
// Grid (split, kv head, request): a request's splits are dispatched
// together, so one long row's splits run in one wave. A row of one live
// split writes acc / l itself; otherwise each live split writes its
// partials [B, Hkv, S, G] and counts itself in arrivals[b, h], and the last
// to arrive merges them and sets the count back to 0 for the next call.
// Splits past the length do nothing; a dead slot's split 0 writes its
// zeros.
template <typename T, int DH, int NR>
__global__ void __launch_bounds__(sdec::kThreads)
grid_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int* __restrict__ block_tables,
                  const int* __restrict__ lengths,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int* __restrict__ arrivals, T* __restrict__ out, int H,
                  int Hkv, int BS, int NBT, int S, int P, float scale_log2) {
  extern __shared__ uint4 smem_raw[];
  __shared__ int last;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z, G = H / Hkv;
  const int len = max(lengths[b], 0);
  T* out_bh = out + ((int64_t)b * H + h * G) * DH;
  if (len == 0) {                           // dead slot: zeros, no merge
    if (s == 0)
      for (int x = threadIdx.x; x < G * DH; x += sdec::kThreads)
        flash::store1(out_bh + x, 0.f);
    return;
  }
  sdec::split_tile<T, T, DH, NR, false>(
      q + ((int64_t)b * H + h * G) * DH, k_pool, v_pool, nullptr, nullptr,
      block_tables + (int64_t)b * NBT, len, s, S, P, G, Hkv, h, BS, part_acc,
      part_ml, ((int64_t)b * Hkv + h) * S * G, arrivals + (int64_t)b * Hkv + h,
      out_bh, scale_log2, reinterpret_cast<char*>(smem_raw), &last,
      threadIdx.x, 0);
}

template <typename T, int DH, int NR>
int launch_grid(const void* q, const void* k_pool, const void* v_pool,
                const void* block_tables, const void* lengths,
                void* part_acc, void* part_ml, void* arrivals, void* out,
                int B, int H, int Hkv, int BS, int NBT, int S, int P,
                cudaStream_t stream) {
  const int smem = sdec::Tile<T, DH, NR, false>::bytes(P * BS);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grid_split_kernel<T, DH, NR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  grid_split_kernel<T, DH, NR>
      <<<dim3(S, Hkv, B), sdec::kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pool),
          static_cast<const T*>(v_pool),
          static_cast<const int*>(block_tables),
          static_cast<const int*>(lengths), static_cast<float*>(part_acc),
          static_cast<float*>(part_ml), static_cast<int*>(arrivals),
          static_cast<T*>(out), H, Hkv, BS, NBT, S, P,
          1.4426950408889634f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_grid_rows(const void* q, const void* k_pool, const void* v_pool,
                     const void* block_tables, const void* lengths,
                     void* part_acc, void* part_ml, void* arrivals, void* out,
                     int B, int H, int Hkv, int BS, int NBT, int S, int P,
                     cudaStream_t stream) {
  const int G = H / Hkv;
  if (G <= 4)
    return launch_grid<T, DH, 4>(q, k_pool, v_pool, block_tables, lengths,
                                 part_acc, part_ml, arrivals, out, B, H, Hkv,
                                 BS, NBT, S, P, stream);
  if (G <= 8)
    return launch_grid<T, DH, 8>(q, k_pool, v_pool, block_tables, lengths,
                                 part_acc, part_ml, arrivals, out, B, H, Hkv,
                                 BS, NBT, S, P, stream);
  return launch_grid<T, DH, kMaxG>(q, k_pool, v_pool, block_tables, lengths,
                                   part_acc, part_ml, arrivals, out, B, H,
                                   Hkv, BS, NBT, S, P, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The work list (work_req, work_blk) is
// flat_work_list's, W items; ipr items a run, with at most kMaxSplits - 1
// runs over a table of NBT entries (a request's parts). part_acc holds
// W*Hkv*G*Dh floats and part_ml W*Hkv*G*2 (scratch the caller allocates);
// arrivals holds B*Hkv ints, all 0, and is left all 0 (the caller keeps it
// for the next call on the same stream). Returns a cudaError_t (0 =
// launched).
extern "C" int repro_decode_attention_flat(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lengths, const void* work_req,
    const void* work_blk, void* part_acc, void* part_ml, void* arrivals,
    void* out, int B, int H, int Hkv, int Dh, int BS, int NBT, int W,
    int ipr, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG || BS <= 0 || NBT <= 0 ||
      W <= 0 || ipr <= 0 || Hkv > 65535 ||
      (int64_t)NBT * BS > INT32_MAX || (int64_t)ipr * BS > INT32_MAX ||
      (NBT + ipr - 1) / ipr + 1 > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 128)
    return launch_flat_rows<float, 128>(q, k_pool, v_pool, block_tables,
                                        lengths, work_req, work_blk, part_acc,
                                        part_ml, arrivals, out, B, H, Hkv, BS,
                                        NBT, W, ipr, st);
  if (dtype == 0 && Dh == 64)
    return launch_flat_rows<float, 64>(q, k_pool, v_pool, block_tables,
                                       lengths, work_req, work_blk, part_acc,
                                       part_ml, arrivals, out, B, H, Hkv, BS,
                                       NBT, W, ipr, st);
  if (dtype == 1 && Dh == 128)
    return launch_flat_rows<__nv_bfloat16, 128>(
        q, k_pool, v_pool, block_tables, lengths, work_req, work_blk,
        part_acc, part_ml, arrivals, out, B, H, Hkv, BS, NBT, W, ipr, st);
  if (dtype == 1 && Dh == 64)
    return launch_flat_rows<__nv_bfloat16, 64>(
        q, k_pool, v_pool, block_tables, lengths, work_req, work_blk,
        part_acc, part_ml, arrivals, out, B, H, Hkv, BS, NBT, W, ipr, st);
  return (int)cudaErrorInvalidValue;
}

// The grid kernel. dtype: 0 = float32, 1 = bfloat16. part_acc holds
// B*Hkv*S*G*Dh floats and part_ml B*Hkv*S*G*2 (scratch the caller
// allocates); arrivals holds B*Hkv ints, all 0, and is left all 0 (the
// caller keeps it for the next call on the same stream); S*P must cover the
// table's NBT entries. Returns a cudaError_t (0 = launched).
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lengths, void* part_acc,
    void* part_ml, void* arrivals, void* out, int B, int H, int Hkv, int Dh,
    int BS, int NBT, int S, int P, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG || BS <= 0 || NBT <= 0 ||
      S <= 0 || P <= 0 || (int64_t)S * P < NBT || S > kMaxSplits ||
      Hkv > 65535 || B > 65535 || (int64_t)S * P * BS > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 128)
    return launch_grid_rows<float, 128>(q, k_pool, v_pool, block_tables,
                                        lengths, part_acc, part_ml, arrivals,
                                        out, B, H, Hkv, BS, NBT, S, P, st);
  if (dtype == 0 && Dh == 64)
    return launch_grid_rows<float, 64>(q, k_pool, v_pool, block_tables,
                                       lengths, part_acc, part_ml, arrivals,
                                       out, B, H, Hkv, BS, NBT, S, P, st);
  if (dtype == 1 && Dh == 128)
    return launch_grid_rows<__nv_bfloat16, 128>(
        q, k_pool, v_pool, block_tables, lengths, part_acc, part_ml,
        arrivals, out, B, H, Hkv, BS, NBT, S, P, st);
  if (dtype == 1 && Dh == 64)
    return launch_grid_rows<__nv_bfloat16, 64>(
        q, k_pool, v_pool, block_tables, lengths, part_acc, part_ml,
        arrivals, out, B, H, Hkv, BS, NBT, S, P, st);
  return (int)cudaErrorInvalidValue;
}
