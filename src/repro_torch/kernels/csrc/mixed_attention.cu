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
// Recast for a machine whose blocks run in parallel. The TPU grid walks a flat
// (segment, logical block) work list in order and carries (m, l, acc) from one
// grid step to the next; here one thread block owns (segment, kv head, tile of
// 16 query rows) and loops over the segment's keys itself, keeping m, l and acc
// in f32 registers. Query row r of a kv head is (chunk token r/G, head h*G + r%G).
// Tiles with no live rows (the padding rows of decode segments, dead segments)
// run no loop and write zeros, so every output element is defined; a row whose
// l stays 0 finishes as 0 (ops.py:86-90).
//
// What bounds it on an H100: decode rows read every K/V byte of their context
// once and do 4*G*Dh flops per key, far below the card's ~295 flops/byte, so
// decode is bound by the bytes of K/V read; long prefill chunks are bound by
// the scores and P*V products. This first version does its arithmetic in f32
// on the CUDA cores: a KV tile (32 keys) is staged in shared memory as f32 and
// the next tile's loads are issued into registers before the current tile is
// computed, so global latency overlaps the math. A tile's rows stop at the
// tile's largest query position (causal pruning), and rows that are not live
// skip the score and P*V work. Each block walks its keys serially, so the
// walk's latency, not the card's throughput, sets the time: small tiles give
// the card more, shorter walks (a 256-token chunk is 48 tiles per kv head). A
// thread of a chunk tile owns 2 query rows; a thread of a decode tile owns 1,
// so a decode row's G heads issue no (predicated-off) work for other rows.
// Not yet done: tensor cores (wgmma), TMA, and a split-KV pass for long
// single decode rows, whose one block per (segment, kv head) leaves most SMs
// idle.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmixed_attention.so mixed_attention.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
template <typename T, int DH, int RPT>
__device__ __forceinline__ void attend_tile(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ bt,
    T* __restrict__ out, float* __restrict__ smem, int s, int h, int r0,
    int tile_live, int nkeys, int ctx, int total, bool chunk, int C, int H,
    int Hkv, int BS, float scale) {
  constexpr int EPV = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int VPR = DH / EPV;             // 16-byte loads per row
  constexpr int KSTR = DH + 4;              // padded K row: no bank conflicts
  constexpr int NV = kKeys * VPR / kThreads;  // K (and V) loads per thread
  constexpr int NW = DH / kLanes / 4;       // float4 columns per thread
  constexpr int ROWS = kRowGroups * RPT;
  static_assert(kKeys * VPR % kThreads == 0, "tile loads must split evenly");
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
  uint4 kr[NV], vr[NV];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int v = tid + n * kThreads, kk = v / VPR, cv = v % VPR;
      const int idx = j0 + kk;
      if (idx < nkeys) {
        const int phys = bt[idx / BS];
        const int64_t off =
            (((int64_t)phys * BS + idx % BS) * Hkv + h) * DH + cv * EPV;
        kr[n] = *reinterpret_cast<const uint4*>(k_pool + off);
        vr[n] = *reinterpret_cast<const uint4*>(v_pool + off);
      } else {  // past the keys this tile needs: zeros, never garbage
        kr[n] = make_uint4(0, 0, 0, 0);
        vr[n] = make_uint4(0, 0, 0, 0);
      }
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int v = tid + n * kThreads, kk = v / VPR, cv = v % VPR;
      float f[EPV];
      unpack(kr[n], f, T());
#pragma unroll
      for (int e = 0; e < EPV; e += 4) store4(k_s + kk * KSTR + cv * EPV + e, f + e);
      unpack(vr[n], f, T());
#pragma unroll
      for (int e = 0; e < EPV; e += 4) store4(v_s + kk * DH + cv * EPV + e, f + e);
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
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
mixed_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
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
    attend_tile<T, DH, kRowsPerThread>(q, k_pool, v_pool, bt, out, smem, s, h,
                                       r0, tile_live, nkeys, ctx, total, chunk,
                                       C, H, Hkv, BS, scale);
    return;
  }
  // decode: at most G <= 8 live rows, one per row group; the tile's other
  // rows are padding and get zeros
  attend_tile<T, DH, 1>(q, k_pool, v_pool, bt, out, smem, s, h, r0,
                        tile_live, nkeys, ctx, total, chunk, C, H, Hkv, BS,
                        scale);
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

template <typename T, int DH>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_tables, const void* ctx_lens,
           const void* seg_lens, const void* tags, void* out, int B, int C,
           int H, int Hkv, int BS, int NBT, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DH>();
  // within the default dynamic shared memory limit: no attribute to set
  static_assert(smem <= 48 * 1024, "tile needs the opt-in smem attribute");
  const int G = H / Hkv;
  dim3 grid((C * G + kTileRows - 1) / kTileRows, Hkv, B);
  mixed_attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(ctx_lens), static_cast<const int*>(seg_lens),
      static_cast<const int*>(tags), static_cast<T*>(out), C, H, Hkv, BS, NBT,
      1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int repro_mixed_attention(const void* q, const void* k_pool,
                                     const void* v_pool,
                                     const void* block_tables,
                                     const void* ctx_lens,
                                     const void* seg_lens, const void* tags,
                                     void* out, int B, int C, int H, int Hkv,
                                     int Dh, int BS, int NBT, int dtype,
                                     void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || BS <= 0 || NBT <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 128)
    return launch<float, 128>(q, k_pool, v_pool, block_tables, ctx_lens,
                              seg_lens, tags, out, B, C, H, Hkv, BS, NBT, st);
  if (dtype == 0 && Dh == 64)
    return launch<float, 64>(q, k_pool, v_pool, block_tables, ctx_lens,
                             seg_lens, tags, out, B, C, H, Hkv, BS, NBT, st);
  if (dtype == 1 && Dh == 128)
    return launch<__nv_bfloat16, 128>(q, k_pool, v_pool, block_tables,
                                      ctx_lens, seg_lens, tags, out, B, C, H,
                                      Hkv, BS, NBT, st);
  if (dtype == 1 && Dh == 64)
    return launch<__nv_bfloat16, 64>(q, k_pool, v_pool, block_tables,
                                     ctx_lens, seg_lens, tags, out, B, C, H,
                                     Hkv, BS, NBT, st);
  return (int)cudaErrorInvalidValue;
}
