// The split-KV decode tile for Hopper (sm_90a), shared by the grid decode
// kernel (decode_attention.cu) and the decode segments of the fused mixed
// kernel (mixed_attention.cu, bf16 and int8 pools).
//
// One warpgroup (128 threads) walks split s of one (row, kv head): the
// row's table entries [s*P, min((s+1)*P, ceil(len/BS))), for the G query
// heads of the kv head. S and P come from the host's shapes and SM count
// (decode_attention.py::grid_split_plan), never from the lengths.
// - Copies: the warpgroup first puts the pool row of each of its keys in
//   shared memory (no copy then waits on a page number or pays a
//   division), then keeps a ring of 4 stages of 32 keys in the pool's type,
//   filled by 16-byte cp.async (rows past the split read as zeros): 3 tiles
//   in flight while one is computed. An int8 pool's f32 scales ride in the
//   same stages (4-byte cp.async).
// - Math: f32 on the CUDA cores, the G query rows sharing each tile: a
//   warp scores 32 keys (a lane per key) for its rows and runs their
//   online softmax with shuffles, then each thread adds P V for one head
//   dim. Rows come in a tile of NR = 4, 8 or 16 (G or more), so every loop
//   over rows has a compile-time bound: a branch on G inside the tile's
//   loops serialised each step on its shared-memory latency. int8 pools:
//   a key's score is (q . k_int) * k_scale, its P times v_scale is what
//   multiplies v_int (l sums the unscaled P), as the reference's
//   dequantize-then-multiply up to f32 rounding.
// - Merge: the split writes its unnormalised (m, l, acc) and counts itself
//   in a per-(row, kv head) arrival count; the last to arrive merges the
//   live splits (start < length), writes acc / l and sets the count back
//   to 0, so the next call on the stream finds it at 0.
// The warpgroup synchronises on named barrier `bar` only, so another
// warpgroup of the block can run another split, or other work, beside it.
#pragma once

#include "async_copy.cuh"
#include "flash_core.cuh"

namespace sdec {

constexpr int kThreads = 128;               // one warpgroup
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;                   // keys per tile: a lane each
constexpr int kStages = 4;                  // ring depth
constexpr int kMaxG = 16;                   // query heads per kv head
constexpr int kMaxSplits = 256;             // the merge's (m, l): 32 KB

using flash::unpack;

__device__ __forceinline__ void unpack(const uint4& raw, float* f, int8_t) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 16; ++e) f[e] = static_cast<float>(b[e]);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

// Shared memory of one split of a pool of type P (int8: kQuant, scales
// beside the rows), NR query rows (G <= NR of them live; rows past G hold
// zero queries, are computed and never written).
template <typename P, int DH, int NR, bool kQuant>
struct Tile {
  static constexpr int EPC = 16 / (int)sizeof(P);  // elements per chunk
  static constexpr int CH = DH / EPC;              // chunks per K/V row
  static constexpr int STR = DH + EPC;             // padded row: no conflicts
  static constexpr int STAGE = 2 * kKeys * STR;    // K rows, then V rows
  static constexpr int RING = kStages * STAGE * (int)sizeof(P);
  static constexpr int MERGE = (2 * kMaxSplits + 1) * kMaxG * 4;
  static constexpr int RING_BYTES = RING > MERGE ? RING : MERGE;  // reused
  static constexpr int RW = NR / kWarps;           // score rows per warp
  static constexpr int TPD = kThreads / DH;        // threads per head dim
  static constexpr int RPT = NR / TPD;             // P V rows per thread
  static constexpr int SCALES = kQuant ? kStages * 2 * kKeys : 0;  // floats
  // ring, q [NR][DH] f32, p [kKeys][NR] f32, alpha [NR] (padded), scales
  static constexpr int SMEM =
      RING_BYTES + (NR * DH + kKeys * NR + 16 + SCALES) * 4;
  // + the pool row of each of the split's P*BS keys (int)
  static __host__ __device__ constexpr int bytes(int keys) {
    return SMEM + keys * (int)sizeof(int);
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

// The last split of a (row, kv head) to finish merges the `live` splits'
// partials [S][G] of (m, l) and acc [DH] into out: acc / l. The (m, l) go
// to shared memory, where a warp per row turns them into weights
// exp2(m_s - max) (lanes over splits); then a thread per 4 dims of a row
// sums the splits' float4s, 16 loads in flight. The partials are read from
// L2 (ld.cg): other blocks wrote them.
template <typename T, int DH>
__device__ __forceinline__ void merge_splits(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ out, float* w_s, int64_t row0, int live, int G, int tid,
    int bar) {
  const float kInf = __int_as_float(0x7f800000);
  const int lane = tid & 31, warp = tid >> 5;
  float* l_s = w_s + live * G;
  float* inv_s = l_s + live * G;
  for (int x = tid; x < live * G; x += kThreads) {
    w_s[x] = __ldcg(part_ml + 2 * (row0 + x));   // (split x / G, row x % G)
    l_s[x] = __ldcg(part_ml + 2 * (row0 + x) + 1);
  }
  bar_sync(bar);
  for (int g = warp; g < G; g += kWarps) {
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
  bar_sync(bar);
  for (int e = tid; e < G * DH / 4; e += kThreads) {
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

// Split s of one row of length len > 0 (keys idx < len) for kv head h: qh
// points at the row's G query heads [G, DH] (T), out_bh at their outputs,
// bt at the row's table. Partials [S][G] of acc [DH] and (m, l), m in
// base-2 units, start at row0 (split 0, head 0); `count` is the row's
// arrival count for h. tid is the thread's index in the warpgroup, bar its
// named barrier, smem its Tile::bytes(P*BS) of shared memory (16-byte
// aligned) and *last a shared int of its own. A split past the length
// returns at once and is not counted.
template <typename T, typename P, int DH, int NR, bool kQuant>
__device__ __forceinline__ void split_tile(
    const T* __restrict__ qh, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ bt, int len,
    int s, int S, int PE, int G, int Hkv, int h, int BS,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int64_t row0,
    int* __restrict__ count, T* __restrict__ out_bh, float scale_log2,
    char* smem, int* last, int tid, int bar) {
  using C = Tile<P, DH, NR, kQuant>;
  const int k_lo = s * PE * BS;
  if (k_lo >= len) return;                  // past the length: not counted
  P* ring = reinterpret_cast<P*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + C::RING_BYTES);
  float* p_s = q_s + NR * DH;               // [kKeys][NR]
  float* a_s = p_s + kKeys * NR;            // [NR] rescale of this tile
  float* sc_s = a_s + 16;                   // [kStages][2][kKeys] scales
  int* row_s = reinterpret_cast<int*>(sc_s + C::SCALES);  // key's pool row
  const int lane = tid & 31, warp = tid >> 5;
  const int live = min(S, (len + PE * BS - 1) / (PE * BS));
  const int n_keys = min(PE * BS, len - k_lo);
  const int nt = (n_keys + kKeys - 1) / kKeys;
  const float kInf = __int_as_float(0x7f800000);

  // the pool row of each key of the split, to shared memory first: a K/V
  // copy then waits on no read of its page number and pays no division
  const int* bts = bt + s * PE;
  for (int x = tid; x < n_keys; x += kThreads)
    row_s[x] = bts[x / BS] * BS + x % BS;
  for (int x = tid; x < NR * DH; x += kThreads)
    q_s[x] = x < G * DH ? to_f(qh[x]) * scale_log2 : 0.f;
  bar_sync(bar);

  auto load = [&](int i) {                  // tile i -> stage i % stages
    P* ks = ring + (i % kStages) * C::STAGE;
    P* vs = ks + kKeys * C::STR;
    for (int x = tid; x < kKeys * C::CH; x += kThreads) {
      const int kk = x / C::CH, c = x % C::CH;
      const int key = i * kKeys + kk;       // from k_lo
      const bool ok = key < n_keys;         // past it: zeros
      const int64_t off =
          ok ? ((int64_t)row_s[key] * Hkv + h) * DH + c * C::EPC : 0;
      acp::cp_async16(ks + kk * C::STR + c * C::EPC, k_pool + off, ok);
      acp::cp_async16(vs + kk * C::STR + c * C::EPC, v_pool + off, ok);
    }
    if constexpr (kQuant) {
      if (tid < 2 * kKeys) {
        const int key = i * kKeys + tid % kKeys;
        const bool ok = key < n_keys;
        const int64_t row = ok ? (int64_t)row_s[key] * Hkv + h : 0;
        acp::cp_async4(sc_s + (i % kStages) * 2 * kKeys + tid,
                       (tid < kKeys ? k_scale : v_scale) + row, ok);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
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
    acp::cp_async_wait<kStages - 2>();      // tile i landed (this thread)
    bar_sync(bar);                          // (all threads); i-1 consumed
    if (i + kStages - 1 < nt) load(i + kStages - 1);
    acp::cp_async_commit();
    const P* ks = ring + (i % kStages) * C::STAGE;
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
      unpack(*reinterpret_cast<const uint4*>(ks + lane * C::STR +
                                             c * C::EPC),
             kf, P());
#pragma unroll
      for (int r = 0; r < C::RW; ++r) {
        float qv[C::EPC];
        lds(qv, q_s + (warp * C::RW + r) * DH + c * C::EPC);
#pragma unroll
        for (int e = 0; e < C::EPC; ++e) sc[r][e % 4] += qv[e] * kf[e];
      }
    }
    // online softmax of each row over the tile's live keys
    const bool key_live = i * kKeys + lane < n_keys;
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      ksc = sc_s[(i % kStages) * 2 * kKeys + lane];
      vsc = sc_s[(i % kStages) * 2 * kKeys + kKeys + lane];
    }
#pragma unroll
    for (int r = 0; r < C::RW; ++r) {
      float x = (sc[r][0] + sc[r][1]) + (sc[r][2] + sc[r][3]);
      if constexpr (kQuant) x *= ksc;
      x = key_live ? x : -kInf;
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
  bar_sync(bar);
  if (tid == 0) {
    *last = atomicAdd(count, 1) == live - 1;
    if (*last) {
      *count = 0;                           // every split has arrived
      __threadfence();                      // before reading their partials
    }
  }
  bar_sync(bar);
  if (*last)
    merge_splits<T, DH>(part_acc, part_ml, out_bh,
                        reinterpret_cast<float*>(smem), row0, live, G, tid,
                        bar);
}

}  // namespace sdec
