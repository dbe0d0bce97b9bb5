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
// Split-KV. The grid is (split, kv head, request): split s walks table
// entries [s*P, min((s+1)*P, ceil(L_b/BS))), with S and P chosen on the host
// from B-independent shapes and the SM count (decode_attention.py::
// grid_split_plan) so that one long row alone gives ~2 blocks per SM; a
// request's splits are dispatched together. A split that starts at or past
// the length exits at once, so no table entry past ceil(L_b/BS) is read
// (the reference pads tables with block 0, the engine with its garbage
// block).
// - Copies: a block first puts the pool row of each of its keys in shared
//   memory (no copy then waits on a page number or pays a division), then
//   keeps a ring of 4 stages of 32 keys in the pool's type, filled by
//   16-byte cp.async (rows past the split read as zeros): 3 tiles in
//   flight while one is computed.
// - Math: f32 on the CUDA cores, the G query rows of the kv head sharing
//   each tile: a warp scores 32 keys (a lane per key) for its rows and runs
//   their online softmax with shuffles, then each thread adds P V for one
//   head dim. Rows come in a tile of 4, 8 or 16 (G or more), so every loop
//   over rows has a compile-time bound: a branch on G inside the tile's
//   loops serialised each step on its shared-memory latency (the old
//   walk's ~7 us a tile).
// - Merge: each split writes its unnormalised (m, l, acc) and counts
//   itself in a per-(request, kv head) arrival count; the last to arrive
//   merges the live splits (start < length) and writes acc / l, and sets
//   the count back to 0. A dead slot's split 0 writes zeros. Sums run in
//   another order than the TPU's sequential walk: split by split, then
//   merged.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdecode_attention.so decode_attention.cu
#include "async_copy.cuh"
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

// ---- grid: split-KV ----
constexpr int kSplitThreads = 128;          // 4 warps
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitKeys = 32;              // keys per tile: a lane each
constexpr int kSplitStages = 4;             // ring depth
constexpr int kMaxG = 16;                   // query heads per kv head
constexpr int kMaxSplits = 256;             // the merge's (m, l): 32 KB

// A tile of NR query rows (G <= NR of them live; NR = 4, 8 or 16), so the
// loops over rows have compile-time bounds and no branch on G: rows past G
// hold zero queries, are computed and never written.
template <typename T, int DH, int NR>
struct SplitTile {
  static constexpr int EPC = 16 / (int)sizeof(T);  // elements per chunk
  static constexpr int CH = DH / EPC;              // chunks per K/V row
  static constexpr int STR = DH + EPC;             // padded row: no conflicts
  static constexpr int STAGE = 2 * kSplitKeys * STR;   // K rows, then V rows
  static constexpr int RING = kSplitStages * STAGE * (int)sizeof(T);
  static constexpr int RW = NR / kSplitWarps;      // score rows per warp
  static constexpr int TPD = kSplitThreads / DH;   // threads per head dim
  static constexpr int RPT = NR / TPD;             // P V rows per thread
  // ring, q [NR][DH] f32, p [kSplitKeys][NR] f32, alpha [NR] (padded)
  static constexpr int SMEM = RING + (NR * DH + kSplitKeys * NR + 16) * 4;
  static_assert(RING >= (2 * kMaxSplits + 1) * kMaxG * 4,
                "the merge reuses the ring");
};  // + the pool row of each of the split's P*BS keys (int), sized at launch

// n consecutive floats of shared memory into registers, 16 bytes a load
template <int N>
__device__ __forceinline__ void lds(float (&r)[N], const float* p) {
  static_assert(N % 2 == 0, "rows come in pairs");
#pragma unroll
  for (int i = 0; i < N; i += (N % 4 == 0 ? 4 : 2)) {
    if constexpr (N % 4 == 0) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      r[i] = x.x; r[i + 1] = x.y; r[i + 2] = x.z; r[i + 3] = x.w;
    } else {
      const float2 x = *reinterpret_cast<const float2*>(p + i);
      r[i] = x.x; r[i + 1] = x.y;
    }
  }
}

// The last split of a (request, kv head) to finish merges the `live`
// splits' partials [S][G] of (m, l) and acc [DH] into out: acc / l. The
// (m, l) go to shared memory, where a warp per row turns them into weights
// exp2(m_s - max) (lanes over splits); then a thread per 4 dims of a row
// sums the splits' float4s, 16 loads in flight. The partials are read from
// L2 (ld.cg): other blocks wrote them.
template <typename T, int DH>
__device__ __forceinline__ void merge_splits(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ out, float* w_s, int64_t row0, int live, int G) {
  const float kInf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* l_s = w_s + live * G;
  float* inv_s = l_s + live * G;
  for (int x = threadIdx.x; x < live * G; x += kSplitThreads) {
    w_s[x] = __ldcg(part_ml + 2 * (row0 + x));   // (split x / G, row x % G)
    l_s[x] = __ldcg(part_ml + 2 * (row0 + x) + 1);
  }
  __syncthreads();
  for (int g = warp; g < G; g += kSplitWarps) {
    float mx = -kInf;
    for (int s = lane; s < live; s += 32) mx = fmaxf(mx, w_s[s * G + g]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
    for (int s = lane; s < live; s += 32) {
      const float a = exp2f(w_s[s * G + g] - mx);
      w_s[s * G + g] = a;
      l += l_s[s * G + g] * a;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) inv_s[g] = l == 0.f ? 1.f : 1.f / l;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * DH / 4; e += kSplitThreads) {
    const int g = e / (DH / 4), d = e % (DH / 4) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
    for (int s = 0; s < live; ++s) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          part_acc + (row0 + (int64_t)s * G + g) * DH + d));
      const float w = w_s[s * G + g];
      acc[0] += v.x * w;
      acc[1] += v.y * w;
      acc[2] += v.z * w;
      acc[3] += v.w * w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] *= inv_s[g];
    flash::store4(out + g * DH + d, acc);
  }
}

// Grid (split, kv head, request): a request's splits are dispatched
// together, so one long row's splits run in one wave. Each live split
// writes its partials [B, Hkv, S, G] of acc [DH] and (m, l), m in base-2
// units, then counts itself in arrivals[b, h]; the last to arrive merges
// them and sets the count back to 0 for the next call. Splits past the
// length do nothing; a dead slot's split 0 writes its zeros.
template <typename T, int DH, int NR>
__global__ void __launch_bounds__(kSplitThreads)
grid_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int* __restrict__ block_tables,
                  const int* __restrict__ lengths,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int* __restrict__ arrivals, T* __restrict__ out, int H,
                  int Hkv, int BS, int NBT, int S, int P, float scale_log2) {
  using C = SplitTile<T, DH, NR>;
  extern __shared__ uint4 smem_raw[];
  __shared__ int last;
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(ring + kSplitStages * C::STAGE);
  float* p_s = q_s + NR * DH;               // [kSplitKeys][NR]
  float* a_s = p_s + kSplitKeys * NR;       // [NR] rescale of this tile
  int* row_s = reinterpret_cast<int*>(a_s + 16);  // pool row of each key
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z, G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = max(lengths[b], 0);
  T* out_bh = out + ((int64_t)b * H + h * G) * DH;
  if (len == 0) {                           // dead slot: zeros, no merge
    if (s == 0)
      for (int x = tid; x < G * DH; x += kSplitThreads)
        flash::store1(out_bh + x, 0.f);
    return;
  }
  const int k_lo = s * P * BS;
  if (k_lo >= len) return;                  // past the length: not counted
  const int live = min(S, (len + P * BS - 1) / (P * BS));
  const int n_keys = min(P * BS, len - k_lo);
  const int nt = (n_keys + kSplitKeys - 1) / kSplitKeys;
  const float kInf = __int_as_float(0x7f800000);

  // the pool row of each key of the split, to shared memory first: a K/V
  // copy then waits on no read of its page number and pays no division
  const int* bt = block_tables + (int64_t)b * NBT + s * P;
  for (int x = tid; x < n_keys; x += kSplitThreads)
    row_s[x] = bt[x / BS] * BS + x % BS;
  const T* qh = q + ((int64_t)b * H + h * G) * DH;   // rows h*G .. +G
  for (int x = tid; x < NR * DH; x += kSplitThreads)
    q_s[x] = x < G * DH ? (float)qh[x] * scale_log2 : 0.f;
  __syncthreads();

  auto load = [&](int i) {                  // tile i -> stage i % stages
    T* ks = ring + (i % kSplitStages) * C::STAGE;
    T* vs = ks + kSplitKeys * C::STR;
    for (int x = tid; x < kSplitKeys * C::CH; x += kSplitThreads) {
      const int kk = x / C::CH, c = x % C::CH;
      const int key = i * kSplitKeys + kk;  // from k_lo
      const bool ok = key < n_keys;         // past it: zeros
      const int64_t off =
          ok ? ((int64_t)row_s[key] * Hkv + h) * DH + c * C::EPC : 0;
      acp::cp_async16(ks + kk * C::STR + c * C::EPC, k_pool + off, ok);
      acp::cp_async16(vs + kk * C::STR + c * C::EPC, v_pool + off, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < kSplitStages - 1; ++i) {
    if (i < nt) load(i);
    acp::cp_async_commit();
  }

  float m[C::RW], l[C::RW];                 // rows warp*RW + r
#pragma unroll
  for (int r = 0; r < C::RW; ++r) {
    m[r] = -kInf;
    l[r] = 0.f;
  }
  const int d = tid % DH, r0 = (tid / DH) * C::RPT;   // P V: dim d, rows r0..
  float acc[C::RPT];
#pragma unroll
  for (int j = 0; j < C::RPT; ++j) acc[j] = 0.f;

  for (int i = 0; i < nt; ++i) {
    acp::cp_async_wait<kSplitStages - 2>();   // tile i landed (this thread)
    __syncthreads();                          // (all threads); i-1 consumed
    if (i + kSplitStages - 1 < nt) load(i + kSplitStages - 1);
    acp::cp_async_commit();
    const T* ks = ring + (i % kSplitStages) * C::STAGE;
    const T* vs = ks + kSplitKeys * C::STR;

    // scores of key `lane` for this warp's RW rows, as 4 partial sums so
    // that the FMAs do not wait on one another
    float sc[C::RW][4];
#pragma unroll
    for (int r = 0; r < C::RW; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) sc[r][u] = 0.f;
#pragma unroll
    for (int c = 0; c < C::CH; ++c) {
      float kf[C::EPC];
      flash::unpack(*reinterpret_cast<const uint4*>(ks + lane * C::STR +
                                                    c * C::EPC),
                    kf, T());
#pragma unroll
      for (int r = 0; r < C::RW; ++r) {
        float qv[C::EPC];
        lds(qv, q_s + (warp * C::RW + r) * DH + c * C::EPC);
#pragma unroll
        for (int e = 0; e < C::EPC; ++e) sc[r][e % 4] += qv[e] * kf[e];
      }
    }
    // online softmax of each row over the tile's live keys
    const bool key_live = i * kSplitKeys + lane < n_keys;
#pragma unroll
    for (int r = 0; r < C::RW; ++r) {
      const float x = key_live
                          ? (sc[r][0] + sc[r][1]) + (sc[r][2] + sc[r][3])
                          : -kInf;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[r], mx);
      const float base = mn == -kInf ? 0.f : mn;
      const float alpha = exp2f(m[r] - base);
      const float p = exp2f(x - base);
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[r] = l[r] * alpha + ps;
      m[r] = mn;
      p_s[lane * NR + warp * C::RW + r] = p;
      if (lane == 0) a_s[warp * C::RW + r] = alpha;
    }
    __syncthreads();

    // acc += p @ v for head dim d of rows r0 .. r0 + RPT - 1
    {
      float a[C::RPT];
      lds(a, a_s + r0);
#pragma unroll
      for (int j = 0; j < C::RPT; ++j) acc[j] *= a[j];
    }
#pragma unroll
    for (int kk = 0; kk < kSplitKeys; ++kk) {
      const float vv = (float)vs[kk * C::STR + d];
      float pk[C::RPT];
      lds(pk, p_s + kk * NR + r0);
#pragma unroll
      for (int j = 0; j < C::RPT; ++j) acc[j] += pk[j] * vv;
    }
  }
  acp::cp_async_wait<0>();                  // nothing in flight

  const int64_t row0 = ((int64_t)b * Hkv + h) * S * G;   // split 0, row 0
  const int64_t mine = row0 + (int64_t)s * G;
#pragma unroll
  for (int j = 0; j < C::RPT; ++j)
    if (r0 + j < G) part_acc[(mine + r0 + j) * DH + d] = acc[j];
#pragma unroll
  for (int r = 0; r < C::RW; ++r) {
    const int g = warp * C::RW + r;
    if (g < G && lane == 0) {
      part_ml[2 * (mine + g)] = m[r];
      part_ml[2 * (mine + g) + 1] = l[r];
    }
  }
  __threadfence();                          // partials visible, then count
  __syncthreads();
  if (tid == 0) {
    int* count = arrivals + (int64_t)b * Hkv + h;
    last = atomicAdd(count, 1) == live - 1;
    if (last) {
      *count = 0;                           // every split has arrived
      __threadfence();                      // before reading their partials
    }
  }
  __syncthreads();
  if (last)
    merge_splits<T, DH>(part_acc, part_ml, out_bh,
                        reinterpret_cast<float*>(smem_raw), row0, live, G);
}

template <typename T, int DH, int NR>
int launch_grid(const void* q, const void* k_pool, const void* v_pool,
                const void* block_tables, const void* lengths,
                void* part_acc, void* part_ml, void* arrivals, void* out,
                int B, int H, int Hkv, int BS, int NBT, int S, int P,
                cudaStream_t stream) {
  const int smem = SplitTile<T, DH, NR>::SMEM + P * BS * (int)sizeof(int);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grid_split_kernel<T, DH, NR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  grid_split_kernel<T, DH, NR>
      <<<dim3(S, Hkv, B), kSplitThreads, smem, stream>>>(
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
