// Online-softmax core of the f32 CUDA-core walks: the chunked paged prefill
// kernel (prefill_attention.cu: f32, and bf16 pools whose block size the
// tensor-core walk does not take) and the contiguous prefill kernel
// (contiguous_prefill.cu: f32); the counterpart of repro/kernels/ops.py's
// _flash_init / _flash_block_update / _flash_finish. split_decode.cuh takes
// its stores.
//
// One thread block of kThreads threads walks a contiguous range of one
// sequence's keys for a tile of query rows of one kv head, reading K/V rows
// [*, Hkv, DH] where a key-addressing functor puts them: a paged pool
// [NB, BS, Hkv, DH] through the sequence's block table (PagedKeys) or a
// contiguous cache [B, S, Hkv, DH] (ContigKeys). Row r of the tile is query
// token r / G and query head h*G + r % G. Each thread
// owns RPT rows (rg + 8*i) and DH/16 output columns; 16 lanes of a half-warp
// share a row group. K/V tiles of kKeys keys are staged in shared memory as
// f32, the next tile's loads are issued into registers before the current
// tile is computed, and m, l and acc stay in f32 registers. Keys outside the
// walked range (or at or past `k_load`) are loaded as zeros, never read from
// stale rows, so padding cannot spread NaN. A row that is not live keeps
// acc = 0 and l = 0 and finishes as 0 (ops.py:86-90).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kThreads = 128;                  // 4 warps
constexpr int kLanes = 16;                     // lanes sharing one row group
constexpr int kRowGroups = kThreads / kLanes;  // 8
constexpr int kTileRows = 16;                  // q rows staged per block
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

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// Shared memory of one block: the q tile, a padded K tile, a V tile (f32).
template <int DH>
constexpr int smem_bytes() {
  return (kTileRows * DH + kKeys * (DH + 4) + kKeys * DH) * 4;
}

// Where key idx of the walked sequence lives: its row in [rows, Hkv, DH].
struct PagedKeys {    // a paged pool [NB, BS, Hkv, DH], through a block table
  const int* __restrict__ bt;
  int bs;
  __device__ __forceinline__ int64_t operator()(int idx) const {
    return (int64_t)bt[idx / bs] * bs + idx % bs;
  }
};

struct ContigKeys {   // a contiguous cache [B, S, Hkv, DH]: base = b * S
  int64_t base;
  __device__ __forceinline__ int64_t operator()(int idx) const {
    return base + idx;
  }
};

// Running softmax state of the RPT rows one thread owns.
template <int DH, int RPT>
struct Rows {
  static constexpr int NW = DH / kLanes / 4;   // float4 columns per thread
  int nr;                                      // of which live
  float m[RPT], l[RPT], acc[RPT][4 * NW];
};

// Walk keys [k_lo, k_hi) of one sequence for rows r0 .. r0 + 8*RPT - 1 of kv
// head h, of which the first `tile_live` are live. q_seg points at the
// sequence's [C, H, DH] queries; `keys` addresses its K/V rows, of which
// keys idx >= k_load read as zeros. Row r keeps keys idx < min(lim, k_hi),
// lim = causal ? min(total, ctx + r/G + 1) : total; a masked key weighs 0.
// Leaves the unnormalised state in `st`. Safe to call several times in one
// block (it synchronises before reusing shared memory).
template <typename T, int DH, int RPT, typename Keys>
__device__ __forceinline__ void attend(
    Rows<DH, RPT>& st, const T* __restrict__ q_seg,
    const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const Keys keys, float* __restrict__ smem, int h, int r0, int tile_live,
    int k_lo, int k_hi, int k_load, bool causal, int ctx, int total, int H,
    int Hkv, float scale) {
  constexpr int EPV = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int VPR = DH / EPV;             // 16-byte loads per row
  constexpr int KSTR = DH + 4;              // padded K row: no bank conflicts
  constexpr int NV = kKeys * VPR / kThreads;  // K (and V) loads per thread
  constexpr int NW = Rows<DH, RPT>::NW;
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

  st.nr = tile_live > rg
              ? min(RPT, (tile_live - rg + kRowGroups - 1) / kRowGroups)
              : 0;
  int lim[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + rg + kRowGroups * i;
    const int full = causal ? min(total, ctx + r / G + 1) : total;
    lim[i] = i < st.nr ? min(full, k_hi) : 0;
    st.m[i] = kNegInf;
    st.l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 4 * NW; ++d) st.acc[i][d] = 0.f;
  }

  __syncthreads();                          // an earlier walk is done with smem
  // ---- q tile -> shared memory (f32, pre-scaled by 1/sqrt(Dh)) ----
  for (int v = tid; v < ROWS * VPR; v += kThreads) {
    const int rr = v / VPR, cv = v % VPR;
    float f[EPV];
    if (rr < tile_live) {
      const int r = r0 + rr, t = r / G, g = r % G;
      const T* src = q_seg + ((int64_t)t * H + h * G + g) * DH + cv * EPV;
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

  // ---- K/V tiles: registers (prefetch) -> shared memory (f32) ----
  const int k_end = min(k_hi, k_load);      // keys read from memory
  uint4 kr[NV], vr[NV];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int v = tid + n * kThreads, kk = v / VPR, cv = v % VPR;
      const int idx = j0 + kk;
      if (idx < k_end) {
        const int64_t off = (keys(idx) * Hkv + h) * DH + cv * EPV;
        kr[n] = *reinterpret_cast<const uint4*>(k_pool + off);
        vr[n] = *reinterpret_cast<const uint4*>(v_pool + off);
      } else {  // past the walked range: zeros, never garbage
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

  if (k_lo < k_hi) fetch(k_lo);
  for (int j0 = k_lo; j0 < k_hi; j0 += kKeys) {
    __syncthreads();                 // previous tile fully consumed
    stash();
    __syncthreads();                 // tile (and, first time, q) visible
    if (j0 + kKeys < k_hi) fetch(j0 + kKeys);   // in flight during math

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
        if (i < st.nr) {
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
      if (i < st.nr) {
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
        const float m_new = fmaxf(st.m[i], mx);
        const float alpha = expf(st.m[i] - m_new);
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
        st.l[i] = st.l[i] * alpha + ps;
        st.m[i] = m_new;
#pragma unroll
        for (int d = 0; d < 4 * NW; ++d) st.acc[i][d] *= alpha;
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
        if (i < st.nr) {
          const float p = __shfl_sync(hmask, sc[i][u], src);
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            st.acc[i][4 * w + 0] += p * vv[w].x;
            st.acc[i][4 * w + 1] += p * vv[w].y;
            st.acc[i][4 * w + 2] += p * vv[w].z;
            st.acc[i][4 * w + 3] += p * vv[w].w;
          }
        }
      }
    }
  }
}

// ops.py:_flash_finish for rows r0 + rg + 8*i < rows of kv head h into
// out_seg [C, H, DH]: acc / l, l == 0 -> 1, so rows that are not live get 0.
template <typename T, int DH, int RPT>
__device__ __forceinline__ void finish(const Rows<DH, RPT>& st,
                                       T* __restrict__ out_seg, int h, int r0,
                                       int rows, int H, int Hkv) {
  constexpr int NW = Rows<DH, RPT>::NW;
  const int rg = threadIdx.x / kLanes, c = threadIdx.x % kLanes;
  const int G = H / Hkv;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + rg + kRowGroups * i;
    if (r >= rows) continue;
    const int t = r / G, g = r % G;
    const float safe = st.l[i] == 0.f ? 1.f : st.l[i];
    T* dst = out_seg + ((int64_t)t * H + h * G + g) * DH;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = st.acc[i][4 * w + e] / safe;
      store4(dst + 4 * c + 64 * w, o);
    }
  }
}

}  // namespace flash
