// Paged decode attention for Hopper (sm_90a): the flat work-list kernel of
// the `flat` backend and the split-KV grid kernel of `grid`.
//
// ---- flat ----
// Replaces the TPU kernel repro/kernels/decode_attention.py::
// paged_decode_attention_flat (body `_flat_paged_kernel`): GQA attention of
// one query token per request over its cache in the paged pool
// [NB, BS, Hkv, Dh], lengths = pos + 1 (0 = dead slot), driven by the flat
// (request, logical block) work list of kernels/ops.py::flat_work_list.
//
// Recast for a machine whose blocks run in parallel. The TPU walks the work
// list in order and carries (m, l, acc) from item to item. Here the list is
// cut into runs of `ipr` consecutive items, and pass 1 gives each run (and kv
// head) its own thread block: the block walks the keys of each request its
// run touches (flash_core.cuh) and writes that request's partial (m, l, acc)
// unnormalised, indexed by the run's first item of the request. Pass 2 merges
// the partials of each (request, kv head) -- one at the request's first item
// and one at every run start inside its items -- and writes acc / l, or zeros
// for a dead slot (the TPU leaves that row unwritten). Padding items (block
// index NBT, aliasing the last request with work) fail the start < length
// guard and do nothing.
//
// What bounds it on an H100: every live K/V byte is read once and each key
// costs 4*G*Dh flops, far below the ~295 flops/byte where the tensor cores
// would bind, so it is bound by the bytes of K/V read. The runs give every
// request a number of blocks in proportion to its length, so one long row no
// longer leaves most SMs idle (the loss the fused kernel shows on long single
// decode rows), and short rows do not pay for the longest. A thread owns one
// query row (two when G > 8), so G = 3 uses 48 of 128 threads for the math
// while all of them load: tensor cores and wider row tiles are later work.
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
#include "flash_core.cuh"
#include "split_decode.cuh"

namespace {

using namespace flash;

// Pass 1: grid (run, kv head). Partials: acc [W, Hkv, G, DH], ml [W, Hkv, G, 2].
template <typename T, int DH, int RPT>
__global__ void __launch_bounds__(kThreads)
flat_decode_partials(const T* __restrict__ q, const T* __restrict__ k_pool,
                     const T* __restrict__ v_pool,
                     const int* __restrict__ block_tables,
                     const int* __restrict__ lengths,
                     const int* __restrict__ work_req,
                     const int* __restrict__ work_blk,
                     float* __restrict__ part_acc, float* __restrict__ part_ml,
                     int W, int H, int Hkv, int BS, int NBT, int ipr,
                     float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int NW = Rows<DH, RPT>::NW;
  const int h = blockIdx.y, G = H / Hkv;
  const int rg = threadIdx.x / kLanes, c = threadIdx.x % kLanes;
  const int w_end = min((int)blockIdx.x * ipr + ipr, W);
  int w = blockIdx.x * ipr;
  while (w < w_end) {
    const int b = work_req[w], len = lengths[b];
    if (work_blk[w] * BS >= len) {   // padding item: the TPU's length guard
      ++w;
      continue;
    }
    int w2 = w + 1;                  // this run's items of request b
    while (w2 < w_end && work_req[w2] == b && work_blk[w2] * BS < len) ++w2;
    const int k_lo = work_blk[w] * BS;
    const int k_hi = min((work_blk[w2 - 1] + 1) * BS, len);
    Rows<DH, RPT> st;
    attend<T, DH, RPT>(st, q + (int64_t)b * H * DH, k_pool, v_pool,
                       PagedKeys{block_tables + (int64_t)b * NBT, BS}, smem,
                       h, 0, G, k_lo, k_hi, k_hi, false, 0, len, H, Hkv,
                       scale);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (i < st.nr) {
        const int64_t row = ((int64_t)w * Hkv + h) * G + rg + kRowGroups * i;
#pragma unroll
        for (int v = 0; v < NW; ++v)
          store4(part_acc + row * DH + 4 * c + 64 * v, &st.acc[i][4 * v]);
        if (c == 0) {
          part_ml[2 * row] = st.m[i];
          part_ml[2 * row + 1] = st.l[i];
        }
      }
    }
    w = w2;
  }
}

// Pass 2: grid (request, kv head); merges the request's partials into out.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flat_decode_merge(const float* __restrict__ part_acc,
                  const float* __restrict__ part_ml,
                  const int* __restrict__ lengths, T* __restrict__ out, int H,
                  int Hkv, int BS, int ipr) {
  const int b = blockIdx.x, h = blockIdx.y, G = H / Hkv;
  int first = 0;                     // the request's first work item
  for (int i = 0; i < b; ++i) first += max(0, (lengths[i] + BS - 1) / BS);
  const int end = first + max(0, (lengths[b] + BS - 1) / BS);
  const int next = (first / ipr + 1) * ipr;   // first run start after it
  for (int e = threadIdx.x; e < G * DH; e += kThreads) {
    const int g = e / DH, d = e % DH;
    float mx = kNegInf;
    for (int p = first; p < end; p = p == first ? next : p + ipr)
      mx = fmaxf(mx, part_ml[2 * (((int64_t)p * Hkv + h) * G + g)]);
    float l = 0.f, acc = 0.f;
    for (int p = first; p < end; p = p == first ? next : p + ipr) {
      const int64_t row = ((int64_t)p * Hkv + h) * G + g;
      const float a = expf(part_ml[2 * row] - mx);
      l += part_ml[2 * row + 1] * a;
      acc += part_acc[row * DH + d] * a;
    }
    store1(out + ((int64_t)b * H + h * G + g) * DH + d,
           acc / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int DH, int RPT>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_tables, const void* lengths,
           const void* work_req, const void* work_blk, void* part_acc,
           void* part_ml, void* out, int B, int H, int Hkv, int BS, int NBT,
           int W, int ipr, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DH>();
  static_assert(smem <= 48 * 1024, "tile needs the opt-in smem attribute");
  const dim3 runs((W + ipr - 1) / ipr, Hkv);
  flat_decode_partials<T, DH, RPT><<<runs, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<const int*>(work_req),
      static_cast<const int*>(work_blk), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), W, H, Hkv, BS, NBT, ipr,
      1.0f / sqrtf((float)DH));
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  flat_decode_merge<T, DH><<<dim3(B, Hkv), kThreads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, BS,
      ipr);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_rows(int G, const void* q, const void* k_pool, const void* v_pool,
                const void* block_tables, const void* lengths,
                const void* work_req, const void* work_blk, void* part_acc,
                void* part_ml, void* out, int B, int H, int Hkv, int BS,
                int NBT, int W, int ipr, cudaStream_t stream) {
  if (G <= kRowGroups)
    return launch<T, DH, 1>(q, k_pool, v_pool, block_tables, lengths,
                            work_req, work_blk, part_acc, part_ml, out, B, H,
                            Hkv, BS, NBT, W, ipr, stream);
  return launch<T, DH, 2>(q, k_pool, v_pool, block_tables, lengths, work_req,
                          work_blk, part_acc, part_ml, out, B, H, Hkv, BS, NBT,
                          W, ipr, stream);
}

// ---- grid: split-KV (split_decode.cuh) ----
using sdec::kMaxG;
using sdec::kMaxSplits;

// Grid (split, kv head, request): a request's splits are dispatched
// together, so one long row's splits run in one wave. Each live split
// writes its partials [B, Hkv, S, G] and counts itself in arrivals[b, h];
// the last to arrive merges them and sets the count back to 0 for the next
// call. Splits past the length do nothing; a dead slot's split 0 writes its
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

// dtype: 0 = float32, 1 = bfloat16. part_acc holds W*Hkv*G*Dh floats and
// part_ml W*Hkv*G*2 (scratch the caller allocates). Returns a cudaError_t
// (0 = both passes launched).
extern "C" int repro_decode_attention_flat(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lengths, const void* work_req,
    const void* work_blk, void* part_acc, void* part_ml, void* out, int B,
    int H, int Hkv, int Dh, int BS, int NBT, int W, int ipr, int dtype,
    void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > flash::kTileRows || BS <= 0 ||
      NBT <= 0 || W <= 0 || ipr <= 0 || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 128)
    return launch_rows<float, 128>(G, q, k_pool, v_pool, block_tables,
                                   lengths, work_req, work_blk, part_acc,
                                   part_ml, out, B, H, Hkv, BS, NBT, W, ipr,
                                   st);
  if (dtype == 0 && Dh == 64)
    return launch_rows<float, 64>(G, q, k_pool, v_pool, block_tables, lengths,
                                  work_req, work_blk, part_acc, part_ml, out,
                                  B, H, Hkv, BS, NBT, W, ipr, st);
  if (dtype == 1 && Dh == 128)
    return launch_rows<__nv_bfloat16, 128>(G, q, k_pool, v_pool, block_tables,
                                           lengths, work_req, work_blk,
                                           part_acc, part_ml, out, B, H, Hkv,
                                           BS, NBT, W, ipr, st);
  if (dtype == 1 && Dh == 64)
    return launch_rows<__nv_bfloat16, 64>(G, q, k_pool, v_pool, block_tables,
                                          lengths, work_req, work_blk,
                                          part_acc, part_ml, out, B, H, Hkv,
                                          BS, NBT, W, ipr, st);
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
