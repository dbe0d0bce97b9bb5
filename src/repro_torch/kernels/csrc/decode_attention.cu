// Paged decode attention for Hopper (sm_90a): the flat work-list kernel of
// the `flat` backend and the (request, kv head) grid kernel of `grid`.
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
// skips the MXU work of blocks at or past a request's length; here one thread
// block owns (request, kv head) and walks that request's blocks
// j < ceil(L_b/BS) in order -- the TPU's accumulation order -- through its
// block table, so no table entry past ceil(L_b/BS) is ever read (the
// reference pads tables with block 0, the engine with its garbage block). A
// length-0 row walks nothing and writes zeros (_flash_finish's l = 0 -> 1).
// Bound, like flat, by the bytes of K/V read. The reference's point about
// this grid holds on the card: every request is one program, so a long row
// sets the kernel's time while the short rows' blocks finish early and leave
// their SMs idle; the flat kernel's runs (and a split-KV pass, later work)
// are the answer to that, not this kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdecode_attention.so decode_attention.cu
#include "flash_core.cuh"

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

// Grid (request, kv head): the (B, Hkv, NBT) TPU grid, its block loop inside.
template <typename T, int DH, int RPT>
__global__ void __launch_bounds__(kThreads)
grid_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   int H, int Hkv, int BS, int NBT, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x, h = blockIdx.y, G = H / Hkv;
  const int len = max(lengths[b], 0);
  Rows<DH, RPT> st;
  attend<T, DH, RPT>(st, q + (int64_t)b * H * DH, k_pool, v_pool,
                     PagedKeys{block_tables + (int64_t)b * NBT, BS}, smem, h,
                     0, G, 0, len, len, false, 0, len, H, Hkv, scale);
  finish<T, DH, RPT>(st, out + (int64_t)b * H * DH, h, 0, G, H, Hkv);
}

template <typename T, int DH, int RPT>
int launch_grid(const void* q, const void* k_pool, const void* v_pool,
                const void* block_tables, const void* lengths, void* out,
                int B, int H, int Hkv, int BS, int NBT, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DH>();
  static_assert(smem <= 48 * 1024, "tile needs the opt-in smem attribute");
  grid_decode_kernel<T, DH, RPT><<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, BS, NBT,
      1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_grid_rows(int G, const void* q, const void* k_pool,
                     const void* v_pool, const void* block_tables,
                     const void* lengths, void* out, int B, int H, int Hkv,
                     int BS, int NBT, cudaStream_t stream) {
  if (G <= kRowGroups)
    return launch_grid<T, DH, 1>(q, k_pool, v_pool, block_tables, lengths,
                                 out, B, H, Hkv, BS, NBT, stream);
  return launch_grid<T, DH, 2>(q, k_pool, v_pool, block_tables, lengths, out,
                               B, H, Hkv, BS, NBT, stream);
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

// The grid kernel. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t
// (0 = launched).
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* lengths, void* out, int B, int H,
    int Hkv, int Dh, int BS, int NBT, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > flash::kTileRows || BS <= 0 ||
      NBT <= 0 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 128)
    return launch_grid_rows<float, 128>(G, q, k_pool, v_pool, block_tables,
                                        lengths, out, B, H, Hkv, BS, NBT, st);
  if (dtype == 0 && Dh == 64)
    return launch_grid_rows<float, 64>(G, q, k_pool, v_pool, block_tables,
                                       lengths, out, B, H, Hkv, BS, NBT, st);
  if (dtype == 1 && Dh == 128)
    return launch_grid_rows<__nv_bfloat16, 128>(G, q, k_pool, v_pool,
                                                block_tables, lengths, out, B,
                                                H, Hkv, BS, NBT, st);
  if (dtype == 1 && Dh == 64)
    return launch_grid_rows<__nv_bfloat16, 64>(G, q, k_pool, v_pool,
                                               block_tables, lengths, out, B,
                                               H, Hkv, BS, NBT, st);
  return (int)cudaErrorInvalidValue;
}
