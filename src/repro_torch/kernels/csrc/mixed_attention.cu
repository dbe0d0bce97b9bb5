// Fused mixed-iteration paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mixed_attention.py::paged_mixed_attention
// (body `_mixed_kernel`, shared core repro/kernels/ops.py::_flash_block_update):
// ONE launch per layer per engine step computes GQA attention for every
// segment of the mixed iteration. A segment is a decode row (tag 0: query row
// 0 only, keys idx < ctx+seg) or a prefill chunk (tag 1: query rows r < seg*G,
// keys idx < ctx+seg and idx <= ctx + r/G). K/V are read from the paged pool
// [NB, BS, Hkv, Dh] through each segment's block table.
//
// What bounds it on an H100: decode rows read every K/V byte of their context
// once and do 4*G*Dh flops per key, far below the card's ~295 flops/byte, so
// decode is bound by the bytes of K/V read and by how many SMs a long row
// can keep busy; long prefill chunks are bound by the score and P*V
// products, which must run on the tensor cores.
//
// bf16 q (pools bf16, or int8 with scales): ONE launch whose blocks take
// one of two roles, read from tags[s] on the device. The 1-D grid is
// (x, kv head, segment), x outermost, x < max(row tiles of C*G / 128,
// ceil(S / 2)): the host knows B, C, NBT, Hkv and the SM count, never the
// tags or lengths, so the engine's one device-to-host read per step stays
// the only one.
// - Chunk segment (tag 1): block x < row tiles runs tc_walk.cuh's
//   tensor-core walk on 128 (token, g) rows, heaviest row tile at x = 0
//   (x outermost, so the long walks start first): TMA from the pool
//   through the table (bf16 pools; maps encoded once per pool) or int8
//   rows staged by cp.async and written into the bf16 operand with the
//   scales kept out of it (int8 pools). Row r sees keys
//   idx < min(ctx + seg, ctx + r / G + 1); rows past the chunk are zeros.
// - Decode segment (tag 0): each warpgroup of block x runs split 2x or
//   2x + 1 of split_decode.cuh's split-KV tile (the grid decode kernel's,
//   S and P from grid_split_plan's rule), the merge folded into the last
//   split to arrive behind a self-resetting arrival count per (segment,
//   kv head). Block x < row tiles first writes zeros to the segment's
//   padding rows in its row tile (rows G .. C*G - 1, and row 0 too for a
//   dead segment), so every output element is defined.
// One blockDim (256) and one dynamic shared-memory size (the larger role's)
// serve both roles.
//
// A second hand-written path, chosen by shape and never because of a
// failure: the walk below (one block per (segment, kv head, tile of 16
// query rows), each walking its keys serially in f32 on the CUDA cores)
// runs f32 q (with f32 or int8 pools), bf16 pools whose block size does
// not tile 64 keys (BS 6, say: tcw::paged_tma_block), and G > 16, which
// the split tile's rows do not hold. It stages each 32-key tile in shared
// memory as f32, issues the next tile's loads into registers before the
// current tile is computed, stops a tile's rows at its largest query
// position, and gives a thread of a chunk tile 2 query rows and of a
// decode tile 1; an int8 tile is dequantized in registers (int8 -> f32 *
// scale) as it is staged. paged_mixed_attention (mixed_attention.py)
// passes the split scratch exactly when the tensor-core path takes the
// call.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmixed_attention.so mixed_attention.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_decode.cuh"
#include "tc_walk.cuh"

namespace {

constexpr int kThreads = 128;                  // 4 warps
constexpr int kLanes = 16;                     // lanes sharing one row group
constexpr int kRowGroups = kThreads / kLanes;  // 8
constexpr int kRowsPerThread = 2;             // of a chunk tile
constexpr int kTileRows = kRowGroups * kRowsPerThread;  // 16 query rows
constexpr int kKeys = 32;                      // keys per KV tile
constexpr int kKeysPerLane = kKeys / kLanes;   // 2
constexpr float kNegInf = -1e30f;              // finite, as ops.py:22

__device__ __forceinline__ void unpack(const uint4& raw, float* f, float) {
  const float4 v = *reinterpret_cast<const float4*>(&raw);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void unpack(const uint4& raw, float* f,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 p = __bfloat1622float2(h[e]);
    f[2 * e] = p.x;
    f[2 * e + 1] = p.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& raw, float* f, int8_t) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 16; ++e) f[e] = static_cast<float>(b[e]);
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

template <int DH>
constexpr int smem_bytes() {
  return (kTileRows * DH + kKeys * (DH + 4) + kKeys * DH) * 4;
}

// One tile of query rows of segment s, kv head h: rows r0 .. r0 + 8*RPT - 1,
// of which the first `tile_live` are live; each thread owns rows rg + 8*i
// (i < RPT). Chunk tiles run RPT = kRowsPerThread; decode tiles run
// RPT = 1, so a decode row's G <= 8 heads issue no work for other rows.
// T is q's and out's type, P the pool's: T, or int8_t with the scales
// k_scale/v_scale [NB, BS, Hkv] (null otherwise).
template <typename T, typename P, int DH, int RPT>
__device__ __forceinline__ void attend_tile(
    const T* __restrict__ q, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ bt,
    T* __restrict__ out, float* __restrict__ smem, int s, int h, int r0,
    int tile_live, int nkeys, int ctx, int total, bool chunk, int C, int H,
    int Hkv, int BS, float scale) {
  constexpr bool kQuant = sizeof(P) == 1;   // int8 pool + f32 scales
  constexpr int EPV = 16 / sizeof(T);       // q elements per 16-byte load
  constexpr int VPR = DH / EPV;             // 16-byte q loads per row
  constexpr int EPK = 16 / sizeof(P);       // pool elements per 16-byte load
  constexpr int VPK = DH / EPK;             // 16-byte pool loads per row
  constexpr int KSTR = DH + 4;              // padded K row: no bank conflicts
  constexpr int NV = kKeys * VPK / kThreads;  // K (and V) loads per thread
  constexpr int NW = DH / kLanes / 4;       // float4 columns per thread
  constexpr int ROWS = kRowGroups * RPT;
  static_assert(kKeys * VPK % kThreads == 0, "tile loads must split evenly");
  static_assert(ROWS <= kTileRows, "q tile exceeds its shared memory");

  float* q_s = smem;                        // [ROWS][DH], scaled
  float* k_s = q_s + kTileRows * DH;        // [kKeys][KSTR]
  float* v_s = k_s + kKeys * KSTR;          // [kKeys][DH]

  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = tid / kLanes, c = tid % kLanes;
  const unsigned hmask = 0xffffu << (lane & 16);  // this half-warp's lanes
  const int G = H / Hkv;

  // this thread's live rows: rg + 8*i for i < nr; lim = keys visible
  const int nr =
      tile_live > rg ? min(RPT, (tile_live - rg + kRowGroups - 1) / kRowGroups)
                     : 0;
  int lim[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + rg + kRowGroups * i;
    lim[i] = i < nr ? (chunk ? min(total, ctx + r / G + 1) : total) : 0;
  }

  // ---- q tile -> shared memory (f32, pre-scaled by 1/sqrt(Dh)) ----
  for (int v = tid; v < ROWS * VPR; v += kThreads) {
    const int rr = v / VPR, cv = v % VPR;
    float f[EPV];
    if (rr < tile_live) {
      const int r = r0 + rr, t = r / G, g = r % G;
      const T* src = q + (((int64_t)s * C + t) * H + h * G + g) * DH + cv * EPV;
      unpack(*reinterpret_cast<const uint4*>(src), f, T());
#pragma unroll
      for (int e = 0; e < EPV; ++e) f[e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < EPV; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPV; e += 4) store4(q_s + rr * DH + cv * EPV + e, f + e);
  }

  float m[RPT], l[RPT], acc[RPT][4 * NW];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 4 * NW; ++d) acc[i][d] = 0.f;
  }

  // ---- K/V tiles: registers (prefetch) -> shared memory (f32) ----
  // int8 mode: each 16-byte vector carries 16 elements of one key row, and
  // the row's scale is loaded beside it (zero past the needed keys)
  uint4 kr[NV], vr[NV];
  float ksr[NV], vsr[NV];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int v = tid + n * kThreads, kk = v / VPK, cv = v % VPK;
      const int idx = j0 + kk;
      if (idx < nkeys) {
        const int phys = bt[idx / BS];
        const int64_t row = ((int64_t)phys * BS + idx % BS) * Hkv + h;
        const int64_t off = row * DH + cv * EPK;
        kr[n] = *reinterpret_cast<const uint4*>(k_pool + off);
        vr[n] = *reinterpret_cast<const uint4*>(v_pool + off);
        if constexpr (kQuant) {
          ksr[n] = k_scale[row];
          vsr[n] = v_scale[row];
        }
      } else {  // past the keys this tile needs: zeros, never garbage
        kr[n] = make_uint4(0, 0, 0, 0);
        vr[n] = make_uint4(0, 0, 0, 0);
        if constexpr (kQuant) {
          ksr[n] = 0.f;
          vsr[n] = 0.f;
        }
      }
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int v = tid + n * kThreads, kk = v / VPK, cv = v % VPK;
      float f[EPK];
      unpack(kr[n], f, P());
      if constexpr (kQuant) {
#pragma unroll
        for (int e = 0; e < EPK; ++e) f[e] *= ksr[n];
      }
#pragma unroll
      for (int e = 0; e < EPK; e += 4) store4(k_s + kk * KSTR + cv * EPK + e, f + e);
      unpack(vr[n], f, P());
      if constexpr (kQuant) {
#pragma unroll
        for (int e = 0; e < EPK; ++e) f[e] *= vsr[n];
      }
#pragma unroll
      for (int e = 0; e < EPK; e += 4) store4(v_s + kk * DH + cv * EPK + e, f + e);
    }
  };

  if (nkeys > 0) fetch(0);
  for (int j0 = 0; j0 < nkeys; j0 += kKeys) {
    __syncthreads();                 // previous tile fully consumed
    stash();
    __syncthreads();                 // tile (and, first time, q) visible
    if (j0 + kKeys < nkeys) fetch(j0 + kKeys);   // in flight during math

    // scores of this thread's rows vs keys c + 16*u of the tile
    float sc[RPT][kKeysPerLane];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) sc[i][u] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 kv[kKeysPerLane];
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u)
        kv[u] = *reinterpret_cast<const float4*>(k_s + (c + kLanes * u) * KSTR + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (i < nr) {
          const float4 qv = *reinterpret_cast<const float4*>(
              q_s + (rg + kRowGroups * i) * DH + d);
#pragma unroll
          for (int u = 0; u < kKeysPerLane; ++u)
            sc[i][u] += qv.x * kv[u].x + qv.y * kv[u].y + qv.z * kv[u].z +
                        qv.w * kv[u].w;
        }
      }
    }

    // online softmax update (ops.py:_flash_block_update); sc becomes p
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (i < nr) {
        float mx = kNegInf;
#pragma unroll
        for (int u = 0; u < kKeysPerLane; ++u) {
          const bool keep = j0 + c + kLanes * u < lim[i];
          sc[i][u] = keep ? sc[i][u] : kNegInf;
          mx = fmaxf(mx, sc[i][u]);
        }
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(hmask, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < kKeysPerLane; ++u) {
          const bool keep = j0 + c + kLanes * u < lim[i];
          sc[i][u] = keep ? expf(sc[i][u] - m_new) : 0.f;
          ps += sc[i][u];
        }
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1)
          ps += __shfl_xor_sync(hmask, ps, o);
        l[i] = l[i] * alpha + ps;
        m[i] = m_new;
#pragma unroll
        for (int d = 0; d < 4 * NW; ++d) acc[i][d] *= alpha;
      }
    }

    // acc += p @ v: p of key kk lives in lane kk%16 of this half-warp
#pragma unroll
    for (int kk = 0; kk < kKeys; ++kk) {
      const int u = kk / kLanes, src = (lane & 16) | (kk % kLanes);
      float4 vv[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w)
        vv[w] = *reinterpret_cast<const float4*>(v_s + kk * DH + 4 * c + 64 * w);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (i < nr) {
          const float p = __shfl_sync(hmask, sc[i][u], src);
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            acc[i][4 * w + 0] += p * vv[w].x;
            acc[i][4 * w + 1] += p * vv[w].y;
            acc[i][4 * w + 2] += p * vv[w].z;
            acc[i][4 * w + 3] += p * vv[w].w;
          }
        }
      }
    }
  }

  // ---- finish (ops.py:_flash_finish): acc / l, l == 0 -> 1 ----
  const int rows = C * G;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + rg + kRowGroups * i;
    if (r >= rows) continue;
    const int t = r / G, g = r % G;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    T* dst = out + (((int64_t)s * C + t) * H + h * G + g) * DH;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = acc[i][4 * w + e] / safe;
      store4(dst + 4 * c + 64 * w, o);
    }
  }
}

// Grid (row tile, kv head, segment); one block per tile of kTileRows rows.
template <typename T, typename P, int DH>
__global__ void __launch_bounds__(kThreads)
mixed_attention_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                       const P* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ ctx_lens,
                       const int* __restrict__ seg_lens,
                       const int* __restrict__ tags, T* __restrict__ out,
                       int C, int H, int Hkv, int BS, int NBT, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int G = H / Hkv;
  const int r0 = tile * kTileRows;
  const int ctx = ctx_lens[s];
  const int total = ctx + seg_lens[s];
  const bool chunk = tags[s] == 1;
  const int* bt = block_tables + (int64_t)s * NBT;
  // live query rows of the segment: a decode row is row 0's G heads
  const int live_rows =
      total <= 0 ? 0 : (chunk ? min(seg_lens[s], C) * G : G);
  const int tile_live = max(0, min(live_rows - r0, kTileRows));
  // keys the tile needs: up to its largest query position (causal pruning)
  const int nkeys =
      tile_live == 0
          ? 0
          : (chunk ? min(total, ctx + (r0 + tile_live - 1) / G + 1) : total);
  if (chunk || G > kRowGroups) {
    attend_tile<T, P, DH, kRowsPerThread>(q, k_pool, v_pool, k_scale, v_scale,
                                          bt, out, smem, s, h, r0, tile_live,
                                          nkeys, ctx, total, chunk, C, H, Hkv,
                                          BS, scale);
    return;
  }
  // decode: at most G <= 8 live rows, one per row group; the tile's other
  // rows are padding and get zeros
  attend_tile<T, P, DH, 1>(q, k_pool, v_pool, k_scale, v_scale, bt, out, smem,
                           s, h, r0, tile_live, nkeys, ctx, total, chunk, C, H,
                           Hkv, BS, scale);
  const int rows = C * G;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  for (int v = threadIdx.x; v < (kTileRows - kRowGroups) * (DH / 4);
       v += kThreads) {
    const int r = r0 + kRowGroups + v / (DH / 4), d = 4 * (v % (DH / 4));
    if (r >= rows) break;
    const int t = r / G, g = r % G;
    store4(out + (((int64_t)s * C + t) * H + h * G + g) * DH + d, zero);
  }
}

template <typename T, typename P, int DH>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* block_tables,
           const void* ctx_lens, const void* seg_lens, const void* tags,
           void* out, int B, int C, int H, int Hkv, int BS, int NBT,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<DH>();
  // within the default dynamic shared memory limit: no attribute to set
  static_assert(smem <= 48 * 1024, "tile needs the opt-in smem attribute");
  const int G = H / Hkv;
  dim3 grid((C * G + kTileRows - 1) / kTileRows, Hkv, B);
  mixed_attention_kernel<T, P, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pool),
      static_cast<const P*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(block_tables),
      static_cast<const int*>(ctx_lens), static_cast<const int*>(seg_lens),
      static_cast<const int*>(tags), static_cast<T*>(out), C, H, Hkv, BS, NBT,
      1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

// q's type T; the pool is T, or int8 when the scales are given.
template <typename T>
int launch_dtype(const void* q, const void* k_pool, const void* v_pool,
                 const void* k_scale, const void* v_scale,
                 const void* block_tables, const void* ctx_lens,
                 const void* seg_lens, const void* tags, void* out, int B,
                 int C, int H, int Hkv, int Dh, int BS, int NBT,
                 cudaStream_t st) {
  const bool quant = k_scale != nullptr;
  if (quant != (v_scale != nullptr)) return (int)cudaErrorInvalidValue;
  if (Dh == 128 && !quant)
    return launch<T, T, 128>(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                             ctx_lens, seg_lens, tags, out, B, C, H, Hkv, BS,
                             NBT, st);
  if (Dh == 64 && !quant)
    return launch<T, T, 64>(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                            ctx_lens, seg_lens, tags, out, B, C, H, Hkv, BS,
                            NBT, st);
  if (Dh == 128 && quant)
    return launch<T, int8_t, 128>(q, k_pool, v_pool, k_scale, v_scale,
                                  block_tables, ctx_lens, seg_lens, tags, out,
                                  B, C, H, Hkv, BS, NBT, st);
  if (Dh == 64 && quant)
    return launch<T, int8_t, 64>(q, k_pool, v_pool, k_scale, v_scale,
                                 block_tables, ctx_lens, seg_lens, tags, out,
                                 B, C, H, Hkv, BS, NBT, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------- tensor-core path ----
using bf16 = __nv_bfloat16;

template <typename P, int DH, int NR>
struct Fused {
  static constexpr bool kQuant = sizeof(P) == 1;
  using Split = sdec::Tile<P, DH, NR, kQuant>;
  // a chunk tile's walk, with a copy of the table's NBT entries
  static int chunk_bytes(int NBT) {
    return kQuant ? tcw::int8_smem_bytes<DH>(NBT)
                  : tcw::tma_smem_bytes<DH>(NBT);
  }
  // one warpgroup's split, keys = P*BS; 16-byte aligned
  static int split_bytes(int keys) { return (Split::bytes(keys) + 15) & ~15; }
  static int smem(int keys, int NBT) {
    const int chunk = chunk_bytes(NBT), split = 2 * split_bytes(keys);
    return chunk > split ? chunk : split;
  }
};

// 1-D grid (x, kv head, segment), x outermost; the role comes from tags[s].
template <typename P, int DH, int NR>
__global__ void __launch_bounds__(tcw::kThreads, 1)
mixed_tc_kernel(const bf16* __restrict__ q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const P* __restrict__ k_pool, const P* __restrict__ v_pool,
                const float* __restrict__ k_scale,
                const float* __restrict__ v_scale,
                const int* __restrict__ block_tables,
                const int* __restrict__ ctx_lens,
                const int* __restrict__ seg_lens,
                const int* __restrict__ tags, float* __restrict__ part_acc,
                float* __restrict__ part_ml, int* __restrict__ arrivals,
                bf16* __restrict__ out, int B, int C, int H, int Hkv, int BS,
                int NBT, int nrt, int S, int PE, int split_bytes,
                float scale_log2) {
  using F = Fused<P, DH, NR>;
  extern __shared__ uint4 smem_raw[];
  __shared__ int last[tcw::kWarpgroups];
  char* smem = reinterpret_cast<char*>(smem_raw);
  const int per_x = Hkv * B;
  const int x = (int)(blockIdx.x / per_x), rem = (int)(blockIdx.x % per_x);
  const int h = rem % Hkv, s = rem / Hkv, G = H / Hkv;
  const int ctx = ctx_lens[s], seg = seg_lens[s], total = ctx + seg;
  const int64_t off = (int64_t)s * C * H * DH;
  const int* bt = block_tables + (int64_t)s * NBT;
  if (tags[s] == 1) {                       // chunk: a tile of 128 rows
    if (x >= nrt) return;
    const int r0 = (nrt - 1 - x) * tcw::kM;
    const int live_rows = total <= 0 ? 0 : max(0, min(seg, C)) * G;
    const tcw::Rows rw{r0, max(0, min(live_rows - r0, tcw::kM)),
                       min(C * G - r0, tcw::kM), ctx, total};
    if constexpr (F::kQuant)
      tcw::walk_int8<DH>(q + off, out + off, k_pool, v_pool, k_scale,
                         v_scale, bt, BS, Hkv, rw, h, H, G, scale_log2,
                         smem);
    else
      tcw::walk_tma<DH>(q + off, out + off,
                        tcw::PagedSrc{&map_k, &map_v, bt, BS, h}, rw, h, H,
                        G, scale_log2, smem);
    return;
  }
  // decode: row 0's G heads attend keys idx < total; the rest are padding
  if (x < nrt) {
    const int r_lo = x * tcw::kM, r_hi = min(C * G, r_lo + tcw::kM);
    const int first = max(r_lo, total > 0 ? G : 0);
    for (int i = threadIdx.x; i < (r_hi - first) * (DH / 8);
         i += tcw::kThreads) {
      const int r = first + i / (DH / 8), c = i % (DH / 8);
      *reinterpret_cast<uint4*>(out + off + ((int64_t)(r / G) * H + h * G +
                                             r % G) * DH + c * 8) =
          make_uint4(0, 0, 0, 0);
    }
  }
  if (total <= 0) return;
  const int wg = threadIdx.x >> 7, sp = 2 * x + wg;
  if (sp >= S) return;
  sdec::split_tile<bf16, P, DH, NR, F::kQuant>(
      q + off + (int64_t)h * G * DH, k_pool, v_pool, k_scale, v_scale, bt,
      total, sp, S, PE, G, Hkv, h, BS, part_acc, part_ml,
      ((int64_t)s * Hkv + h) * S * G, arrivals + (int64_t)s * Hkv + h,
      out + off + (int64_t)h * G * DH, scale_log2, smem + wg * split_bytes,
      &last[wg], threadIdx.x & 127, 1 + wg);
}

template <typename P, int DH, int NR>
int launch_tc(const void* q, const void* k_pool, const void* v_pool,
              const void* k_scale, const void* v_scale,
              const void* block_tables, const void* ctx_lens,
              const void* seg_lens, const void* tags, void* part_acc,
              void* part_ml, void* arrivals, void* out, int B, int C, int H,
              int Hkv, int BS, int NBT, int NB, int S, int PE,
              cudaStream_t stream) {
  using F = Fused<P, DH, NR>;
  const int split_bytes = F::split_bytes(PE * BS);
  const int smem = F::smem(PE * BS, NBT);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  CUtensorMap map_k{}, map_v{};
  if constexpr (!F::kQuant) {
    int rc = tcw::pool_map(&map_k, k_pool, NB, BS, Hkv, DH);
    if (rc == 0) rc = tcw::pool_map(&map_v, v_pool, NB, BS, Hkv, DH);
    if (rc != 0) return rc;
  }
  const int G = H / Hkv;
  const int nrt = (int)(((int64_t)C * G + tcw::kM - 1) / tcw::kM);
  const int X = nrt > (S + 1) / 2 ? nrt : (S + 1) / 2;
  const int64_t blocks = (int64_t)X * Hkv * B;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  static int smem_set = 0;                  // the attribute, once per size
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        mixed_tc_kernel<P, DH, NR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  mixed_tc_kernel<P, DH, NR>
      <<<(unsigned)blocks, tcw::kThreads, smem, stream>>>(
          static_cast<const bf16*>(q), map_k, map_v,
          static_cast<const P*>(k_pool), static_cast<const P*>(v_pool),
          static_cast<const float*>(k_scale),
          static_cast<const float*>(v_scale),
          static_cast<const int*>(block_tables),
          static_cast<const int*>(ctx_lens),
          static_cast<const int*>(seg_lens), static_cast<const int*>(tags),
          static_cast<float*>(part_acc), static_cast<float*>(part_ml),
          static_cast<int*>(arrivals), static_cast<bf16*>(out), B, C, H, Hkv,
          BS, NBT, nrt, S, PE, split_bytes,
          1.4426950408889634f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <typename P, int DH>
int launch_tc_rows(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* block_tables, const void* ctx_lens,
                   const void* seg_lens, const void* tags, void* part_acc,
                   void* part_ml, void* arrivals, void* out, int B, int C,
                   int H, int Hkv, int BS, int NBT, int NB, int S, int PE,
                   cudaStream_t st) {
  const int G = H / Hkv;
  if (G <= 4)
    return launch_tc<P, DH, 4>(q, k_pool, v_pool, k_scale, v_scale,
                               block_tables, ctx_lens, seg_lens, tags,
                               part_acc, part_ml, arrivals, out, B, C, H, Hkv,
                               BS, NBT, NB, S, PE, st);
  if (G <= 8)
    return launch_tc<P, DH, 8>(q, k_pool, v_pool, k_scale, v_scale,
                               block_tables, ctx_lens, seg_lens, tags,
                               part_acc, part_ml, arrivals, out, B, C, H, Hkv,
                               BS, NBT, NB, S, PE, st);
  return launch_tc<P, DH, sdec::kMaxG>(q, k_pool, v_pool, k_scale, v_scale,
                                       block_tables, ctx_lens, seg_lens, tags,
                                       part_acc, part_ml, arrivals, out, B, C,
                                       H, Hkv, BS, NBT, NB, S, PE, st);
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16. k_scale/v_scale null:
// the pools are q's dtype; given: the pools are int8 and the scales f32
// [NB, BS, Hkv]. NB: blocks in the pool. part_acc null: the CUDA-core walk;
// given: the tensor-core path, with the split plan (S, P) and its scratch:
// part_acc B*Hkv*S*G*Dh floats, part_ml B*Hkv*S*G*2, arrivals B*Hkv ints,
// all 0, left all 0 (the caller keeps them for the next call on the same
// stream). Returns a cudaError_t (0 = launched).
extern "C" int repro_mixed_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* ctx_lens, const void* seg_lens, const void* tags, void* out,
    void* part_acc, void* part_ml, void* arrivals, int B, int C, int H,
    int Hkv, int Dh, int BS, int NBT, int NB, int S, int P, int dtype,
    void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || BS <= 0 || NBT <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
  if (quant != (v_scale != nullptr)) return (int)cudaErrorInvalidValue;
  if (part_acc != nullptr) {
    if (dtype != 1 || H / Hkv > sdec::kMaxG || NB <= 0 ||
        (!quant && !tcw::paged_tma_block(BS)) || S <= 0 || P <= 0 ||
        S > sdec::kMaxSplits || (int64_t)S * P < NBT ||
        (int64_t)S * P * BS > INT32_MAX || part_ml == nullptr ||
        arrivals == nullptr)
      return (int)cudaErrorInvalidValue;
    if (Dh == 128 && !quant)
      return launch_tc_rows<bf16, 128>(
          q, k_pool, v_pool, k_scale, v_scale, block_tables, ctx_lens,
          seg_lens, tags, part_acc, part_ml, arrivals, out, B, C, H, Hkv, BS,
          NBT, NB, S, P, st);
    if (Dh == 64 && !quant)
      return launch_tc_rows<bf16, 64>(
          q, k_pool, v_pool, k_scale, v_scale, block_tables, ctx_lens,
          seg_lens, tags, part_acc, part_ml, arrivals, out, B, C, H, Hkv, BS,
          NBT, NB, S, P, st);
    if (Dh == 128 && quant)
      return launch_tc_rows<int8_t, 128>(
          q, k_pool, v_pool, k_scale, v_scale, block_tables, ctx_lens,
          seg_lens, tags, part_acc, part_ml, arrivals, out, B, C, H, Hkv, BS,
          NBT, NB, S, P, st);
    if (Dh == 64 && quant)
      return launch_tc_rows<int8_t, 64>(
          q, k_pool, v_pool, k_scale, v_scale, block_tables, ctx_lens,
          seg_lens, tags, part_acc, part_ml, arrivals, out, B, C, H, Hkv, BS,
          NBT, NB, S, P, st);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return launch_dtype<float>(q, k_pool, v_pool, k_scale, v_scale,
                               block_tables, ctx_lens, seg_lens, tags, out, B,
                               C, H, Hkv, Dh, BS, NBT, st);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale,
                                       block_tables, ctx_lens, seg_lens, tags,
                                       out, B, C, H, Hkv, Dh, BS, NBT, st);
  return (int)cudaErrorInvalidValue;
}
