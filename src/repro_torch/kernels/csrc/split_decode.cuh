// The split-KV decode tile for Hopper (sm_90a): one warpgroup attends the G
// query heads of one kv head, for one query token, over a span of its keys;
// the spans of a (row, kv head) are merged by the last to finish. It runs
// the decode rows of four kernels, each cutting a row into spans from host
// shapes only, never from the lengths:
// - #4, the grid paged decode (decode_attention.cu), and #1's decode rows
//   (mixed_attention.cu, bf16 and int8 pools): split s walks the row's
//   table entries [s*P, min((s+1)*P, ceil(len/BS))) (split_tile below;
//   decode_attention.py::grid_split_plan);
// - #2, the flat paged decode (decode_attention.cu): a run of the flat work
//   list walks, one after another, the blocks of each request it holds;
// - #5, the contiguous decode (contiguous_decode.cu): split s walks keys
//   [s*K, (s+1)*K) of the row's cache [B, S, Hkv, Dh], padded or ragged
//   (decode_attention.py::contiguous_split_plan).
//
// - Keys: key i of a span lives where a key policy says: TableKeys first
//   puts the pool row of each key of the span in shared memory (no copy
//   then waits on a page number or pays a division), ContigKeys is base + i.
// - Copies: a ring of STAGES stages of 32 keys in the pool's type, filled
//   by 16-byte cp.async, so STAGES - 1 tiles are in flight while one is
//   computed; keys past the span's loaded ones read as zeros. An int8
//   pool's f32 scales ride in the same stages (4-byte cp.async). Four
//   stages by default; a kernel that streams a whole cache takes three,
//   so that four blocks fit an SM instead of three (bf16, Dh 128).
// - Math: f32 on the CUDA cores (decode does ~3 flops a byte: the tensor
//   cores buy nothing), the G query rows sharing each tile: a warp scores
//   32 keys (a lane per key) for its rows and runs their online softmax
//   with shuffles, in base 2 (q pre-scaled by log2(e)/sqrt(Dh)), then each
//   thread adds P V for one head dim. Rows come in a tile of NR = 4, 8 or
//   16 (G or more), so every loop over rows has a compile-time bound: a
//   branch on G inside the tile's loops serialised each step on its
//   shared-memory latency. K chunks go from shared memory to f32 by shifts
//   (bf16 is the top half of an f32), no register's address taken.
// - Masks: keys i < n_live are scored; keys n_live <= i < n_keys score the
//   finite kMasked (-1e30), so, as in the TPU kernels' _flash_block_update,
//   such a key weighs 0 once a live key was seen and 1 while none was: a
//   span with no live key sums V over its walked rows and counts them in l,
//   and the merge weighs it 0 beside a span with a live key. Keys past
//   n_keys weigh nothing. int8 pools: a key's score is (q . k_int) *
//   k_scale, its P times v_scale multiplies v_int (l sums the unscaled P),
//   as the reference's dequantize-then-multiply up to f32 rounding.
// - Merge: a (row, kv head) of one part writes acc / l itself. Otherwise
//   each part writes its unnormalised (m, l, acc) to its slot and counts
//   itself in the (row, kv head)'s arrival count; the last of the `parts`
//   to arrive merges the slots in slot order (two calls give the same bits,
//   whatever the order of arrival), writes acc / l and sets the count back
//   to 0, so the next call on the stream finds it at 0.
// The warpgroup synchronises on named barrier `bar` only, so another
// warpgroup of the block can run another span beside it, and one
// warpgroup may walk several spans one after another.
#pragma once

#include "async_copy.cuh"
#include "flash_core.cuh"

namespace sdec {

constexpr int kThreads = 128;               // one warpgroup
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;                   // keys per tile: a lane each
constexpr int kStages = 4;                  // ring depth (default)
constexpr int kMaxG = 16;                   // query heads per kv head
constexpr int kMaxSplits = 256;             // the merge's (m, l): 32 KB
constexpr float kMasked = -1e30f;           // finite, as ops.py's NEG_INF

// 16 bytes of a K row in shared memory, as f32
__device__ __forceinline__ void chunk(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}

__device__ __forceinline__ void chunk(const __nv_bfloat16* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {             // element 2e is the low half
    f[2 * e] = __uint_as_float(w[e] << 16);
    f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

__device__ __forceinline__ void chunk(const int8_t* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 16; ++e)              // byte e % 4 of word e / 4
    f[e] = static_cast<float>(
        static_cast<int>(w[e / 4] << (24 - 8 * (e % 4))) >> 24);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

// Shared memory of one span of a pool of type P (int8: kQuant, scales
// beside the rows), NR query rows (G <= NR of them live; rows past G hold
// zero queries, are computed and never written), a ring of STAGES tiles.
template <typename P, int DH, int NR, bool kQuant, int STAGES = kStages>
struct Tile {
  static constexpr int EPC = 16 / (int)sizeof(P);  // elements per chunk
  static constexpr int CH = DH / EPC;              // chunks per K/V row
  static constexpr int STR = DH + EPC;             // padded row: no conflicts
  static constexpr int STAGE = 2 * kKeys * STR;    // K rows, then V rows
  static constexpr int RING = STAGES * STAGE * (int)sizeof(P);
  static constexpr int MERGE = (2 * kMaxSplits + 1) * kMaxG * 4;
  static constexpr int RING_BYTES = RING > MERGE ? RING : MERGE;  // reused
  static constexpr int RW = NR / kWarps;           // score rows per warp
  static constexpr int TPD = kThreads / DH;        // threads per head dim
  static constexpr int RPT = NR / TPD;             // P V rows per thread
  static constexpr int SCALES = kQuant ? STAGES * 2 * kKeys : 0;  // floats
  // ring, q [NR][DH] f32, p [kKeys][NR] f32, alpha [NR] (padded), scales
  static constexpr int SMEM =
      RING_BYTES + (NR * DH + kKeys * NR + 16 + SCALES) * 4;
  // + the pool row of each of the span's keys (int; TableKeys only)
  static __host__ __device__ constexpr int bytes(int keys) {
    return SMEM + keys * (int)sizeof(int);
  }
};

// Where key i of a span lives: its row in [rows, Hkv, DH].
struct TableKeys {     // a paged pool [NB, BS, Hkv, DH] through a table
  const int* __restrict__ bt;               // the span's first entry
  int bs;
  int* rows = nullptr;                      // staged: the pool row of key i
  __device__ __forceinline__ void stage(int* smem_rows, int n, int tid) {
    rows = smem_rows;
    for (int x = tid; x < n; x += kThreads) rows[x] = bt[x / bs] * bs + x % bs;
  }
  __device__ __forceinline__ int64_t operator()(int i) const {
    return rows[i];
  }
};

struct ContigKeys {    // a contiguous cache [B, S, Hkv, DH]: b * S + k_lo
  int64_t base;
  __device__ __forceinline__ void stage(int*, int, int) {}
  __device__ __forceinline__ int64_t operator()(int i) const {
    return base + i;
  }
};

// The keys of a span: n_keys walked, the first n_load of them read from
// memory (the rest are zero rows), the first n_live scored (the rest score
// kMasked).
struct Span {
  int n_keys, n_load, n_live;
};

// Where part j of a (row, kv head) keeps its partials: the index of its
// head-0 row in part_ml [*, 2] and part_acc [*, DH]; heads 1 .. G-1 follow.
struct SplitSlots {    // split j of the row's S: row0 + j * G
  int64_t row0;
  int G;
  __device__ __forceinline__ int64_t operator()(int j) const {
    return row0 + (int64_t)j * G;
  }
};

__device__ __forceinline__ void bar_sync(int bar) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(kThreads) : "memory");
}

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

// The last part of a (row, kv head) to finish merges the `parts` slots'
// partials (m, l) and acc [DH] of its G rows into out: acc / l, slots in
// order. The (m, l) go to shared memory, where a warp per row turns them
// into weights exp2(m_j - max) (lanes over slots); then a thread per 4
// dims of a row sums the slots' float4s, 16 loads in flight. The partials
// are read from L2 (ld.cg): other blocks wrote them.
template <typename T, int DH, typename Slots>
__device__ __forceinline__ void merge_splits(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ out, float* w_s, Slots slots, int parts, int G, int tid,
    int bar) {
  const float kInf = __int_as_float(0x7f800000);
  const int lane = tid & 31, warp = tid >> 5;
  float* l_s = w_s + parts * G;
  float* inv_s = l_s + parts * G;
  for (int x = tid; x < parts * G; x += kThreads) {
    const int64_t row = slots(x / G) + x % G;     // (slot x / G, row x % G)
    w_s[x] = __ldcg(part_ml + 2 * row);
    l_s[x] = __ldcg(part_ml + 2 * row + 1);
  }
  bar_sync(bar);
  for (int g = warp; g < G; g += kWarps) {
    float mx = -kInf;
    for (int s = lane; s < parts; s += 32) mx = fmaxf(mx, w_s[s * G + g]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
    for (int s = lane; s < parts; s += 32) {
      const float a = exp2f(w_s[s * G + g] - mx);
      w_s[s * G + g] = a;
      l += l_s[s * G + g] * a;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) inv_s[g] = l == 0.f ? 1.f : 1.f / l;
  }
  bar_sync(bar);
  for (int e = tid; e < G * DH / 4; e += kThreads) {
    const int g = e / (DH / 4), d = e % (DH / 4) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
    for (int s = 0; s < parts; ++s) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          part_acc + (slots(s) + g) * DH + d));
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

// Part `part` of `parts` of one (row, kv head h): walk the span's keys for
// the G query heads at qh [G, DH] (T), then write acc / l to out_bh [G, DH]
// (one part), or the partials to slots(part) and, if last to arrive, merge
// (`count` is the (row, kv head)'s arrival count). tid is the thread's index
// in the warpgroup, bar its named barrier, smem its Tile::bytes(n_keys) of
// shared memory (16-byte aligned; Tile::SMEM with ContigKeys) and *last a
// shared int of its own. n_keys > 0. STAGES: the ring's depth (STAGES - 1
// tiles in flight while one is computed).
template <typename T, typename P, int DH, int NR, bool kQuant,
          int STAGES = kStages, typename Keys, typename Slots>
__device__ __forceinline__ void attend(
    const T* __restrict__ qh, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, Keys keys, const Span span, int G,
    int Hkv, int h, float scale_log2, Slots slots, int part, int parts,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    int* __restrict__ count, T* __restrict__ out_bh, char* smem, int* last,
    int tid, int bar) {
  using C = Tile<P, DH, NR, kQuant, STAGES>;
  P* ring = reinterpret_cast<P*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + C::RING_BYTES);
  float* p_s = q_s + NR * DH;               // [kKeys][NR]
  float* a_s = p_s + kKeys * NR;            // [NR] rescale of this tile
  float* sc_s = a_s + 16;                   // [STAGES][2][kKeys] scales
  const int lane = tid & 31, warp = tid >> 5;
  const int nt = (span.n_keys + kKeys - 1) / kKeys;

  keys.stage(reinterpret_cast<int*>(sc_s + C::SCALES), span.n_keys, tid);
  for (int x = tid; x < NR * DH; x += kThreads)
    q_s[x] = x < G * DH ? to_f(qh[x]) * scale_log2 : 0.f;
  bar_sync(bar);

  auto load = [&](int i) {                  // tile i -> stage i % stages
    P* ks = ring + (i % STAGES) * C::STAGE;
    P* vs = ks + kKeys * C::STR;
    for (int x = tid; x < kKeys * C::CH; x += kThreads) {
      const int kk = x / C::CH, c = x % C::CH;
      const int key = i * kKeys + kk;
      const bool ok = key < span.n_load;    // past it: zeros
      const int64_t off = ok ? (keys(key) * Hkv + h) * DH + c * C::EPC : 0;
      acp::cp_async16(ks + kk * C::STR + c * C::EPC, k_pool + off, ok);
      acp::cp_async16(vs + kk * C::STR + c * C::EPC, v_pool + off, ok);
    }
    if constexpr (kQuant) {
      if (tid < 2 * kKeys) {
        const int key = i * kKeys + tid % kKeys;
        const bool ok = key < span.n_load;
        const int64_t row = ok ? keys(key) * Hkv + h : 0;
        acp::cp_async4(sc_s + (i % STAGES) * 2 * kKeys + tid,
                       (tid < kKeys ? k_scale : v_scale) + row, ok);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nt) load(i);
    acp::cp_async_commit();
  }

  float m[C::RW], l[C::RW];                 // rows warp*RW + r
#pragma unroll
  for (int r = 0; r < C::RW; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
  }
  const int d = tid % DH, r0 = (tid / DH) * C::RPT;   // P V: dim d, rows r0..
  float acc[C::RPT];
#pragma unroll
  for (int j = 0; j < C::RPT; ++j) acc[j] = 0.f;

  for (int i = 0; i < nt; ++i) {
    acp::cp_async_wait<STAGES - 2>();       // tile i landed (this thread)
    bar_sync(bar);                          // (all threads); i-1 consumed
    if (i + STAGES - 1 < nt) load(i + STAGES - 1);
    acp::cp_async_commit();
    const P* ks = ring + (i % STAGES) * C::STAGE;
    const P* vs = ks + kKeys * C::STR;

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
      chunk(ks + lane * C::STR + c * C::EPC, kf);
#pragma unroll
      for (int r = 0; r < C::RW; ++r) {
        float qv[C::EPC];
        lds(qv, q_s + (warp * C::RW + r) * DH + c * C::EPC);
#pragma unroll
        for (int e = 0; e < C::EPC; ++e) sc[r][e % 4] += qv[e] * kf[e];
      }
    }
    // online softmax of each row over the tile's walked keys
    const int key = i * kKeys + lane;
    const bool walked = key < span.n_keys, scored = key < span.n_live;
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      ksc = sc_s[(i % STAGES) * 2 * kKeys + lane];
      vsc = sc_s[(i % STAGES) * 2 * kKeys + kKeys + lane];
    }
#pragma unroll
    for (int r = 0; r < C::RW; ++r) {
      float x = (sc[r][0] + sc[r][1]) + (sc[r][2] + sc[r][3]);
      if constexpr (kQuant) x *= ksc;
      x = scored ? x : kMasked;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - mn);
      const float p = walked ? exp2f(x - mn) : 0.f;
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[r] = l[r] * alpha + ps;
      m[r] = mn;
      p_s[lane * NR + warp * C::RW + r] = kQuant ? p * vsc : p;
      if (lane == 0) a_s[warp * C::RW + r] = alpha;
    }
    bar_sync(bar);

    // acc += p @ v for head dim d of rows r0 .. r0 + RPT - 1
    {
      float a[C::RPT];
      lds(a, a_s + r0);
#pragma unroll
      for (int j = 0; j < C::RPT; ++j) acc[j] *= a[j];
    }
#pragma unroll
    for (int kk = 0; kk < kKeys; ++kk) {
      const float vv = to_f(vs[kk * C::STR + d]);
      float pk[C::RPT];
      lds(pk, p_s + kk * NR + r0);
#pragma unroll
      for (int j = 0; j < C::RPT; ++j) acc[j] += pk[j] * vv;
    }
  }
  acp::cp_async_wait<0>();                  // nothing in flight

  if (parts == 1) {                         // the only part: acc / l to out
    bar_sync(bar);                          // every thread is done with a_s
#pragma unroll
    for (int r = 0; r < C::RW; ++r)
      if (lane == 0)
        a_s[warp * C::RW + r] = l[r] == 0.f ? 1.f : 1.f / l[r];
    bar_sync(bar);
#pragma unroll
    for (int j = 0; j < C::RPT; ++j)
      if (r0 + j < G)
        flash::store1(out_bh + (r0 + j) * DH + d, acc[j] * a_s[r0 + j]);
    return;
  }
  const int64_t mine = slots(part);
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
  bar_sync(bar);
  if (tid == 0) {
    *last = atomicAdd(count, 1) == parts - 1;
    if (*last) {
      *count = 0;                           // every part has arrived
      __threadfence();                      // before reading their partials
    }
  }
  bar_sync(bar);
  if (*last)
    merge_splits<T, DH>(part_acc, part_ml, out_bh,
                        reinterpret_cast<float*>(smem), slots, parts, G, tid,
                        bar);
}

// Split s of S of one paged row of length len > 0 (#4, #1's decode rows):
// its table entries [s*PE, min((s+1)*PE, ceil(len/BS))) from bt, the row's
// table; partials [S][G] from row0 (split 0, head 0). A split past the
// length returns at once and is not counted; the rest are as attend's.
template <typename T, typename P, int DH, int NR, bool kQuant>
__device__ __forceinline__ void split_tile(
    const T* __restrict__ qh, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ bt, int len,
    int s, int S, int PE, int G, int Hkv, int h, int BS,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int64_t row0,
    int* __restrict__ count, T* __restrict__ out_bh, float scale_log2,
    char* smem, int* last, int tid, int bar) {
  const int keys = PE * BS, k_lo = s * keys;
  if (k_lo >= len) return;                  // past the length: not counted
  const int n = min(keys, len - k_lo);
  attend<T, P, DH, NR, kQuant>(
      qh, k_pool, v_pool, k_scale, v_scale, TableKeys{bt + s * PE, BS},
      Span{n, n, n}, G, Hkv, h, scale_log2, SplitSlots{row0, G}, s,
      min(S, (len + keys - 1) / keys), part_acc, part_ml, count, out_bh, smem,
      last, tid, bar);
}

}  // namespace sdec
