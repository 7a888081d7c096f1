// Paged GQA decode attention for Hopper (sm_90a): one query per slot against
// a page pool through per-slot block tables.
//
// Replaces: django_assistant_bot_tpu/ops/attention.py
// `paged_gqa_decode_attention` (:228-325), an XLA fori_loop over logical
// blocks in the JAX package.  Composing it from PyTorch ops would gather each
// slot's pages into a dense [B, KH, S, D] row first; this kernel reads every
// page in place, once.
//
// Layouts: q, out are [B, H, 1, D]; k_pool, v_pool are [P, KH, page, D];
// block_tables [B, NB] int32 (entries >= P mean "unallocated"); positions [B]
// int32; active [B] bool or null.  Types: bf16 and f32 pools (same type as q);
// accumulation in f32.  D is 16, 32, 64, 128 or 256 (Gemma); H / KH is 1, 2,
// 4 or 8, and at most 4 at D = 256, where the per-warp merge buffer of eight
// query heads would pass the 48 KiB of static shared memory; page is a
// multiple of 4.
//
// What bounds it on the H100: each key is used by H / KH queries of one
// token, so the work is ~4 * G operations per 2 * D bytes of K/V read — far
// below the card's ~295 operations per byte.  The bound is the bytes of the
// live pages over the 3.35 TB/s of HBM.
//
// Design (split over pages, then combine — "flash decoding"): a decode batch
// has only B * KH (slot, KV head) pairs, 64 at 8 slots of Llama-3-8B, too few
// to fill 132 SMs, and one row's keys read in sequence are latency-bound.  So
// the first kernel runs one block per (slot, KV head, logical page): its eight
// warps take four consecutive key rows at a time (all loads issued before
// any use), each lane holding D / 32 consecutive elements of a row (one on
// lanes < D when D < 32) so a warp's load is contiguous; the G = H / KH query
// heads of the KV head share every row read; each warp keeps an f32 online
// softmax (running max, sum, accumulator) per query head, and the block
// merges its warps in shared memory into one partial (max, sum, accumulator)
// per query head in a small f32 scratch.  The second kernel merges the
// pages of each (slot, query head) and normalises.  Each block reads its
// own row's position and block-table entries: no host round trip.
//
// Loop bounds: the JAX loop runs logical blocks [lo, hi) from the batch's
// largest active position (and, with a window, its smallest), and masks
// per row.  Here each row walks the intersection of that range with its own
// [lo_row, hi_row): the blocks left out are fully masked for an active row,
// so the result is the same up to rounding order.  An inactive row keeps the
// batch range (its output is never used by the engine).  Masked keys score
// -inf and weigh exactly 0 (never the JAX code's finite -1e30: a state that
// has seen no live key keeps m = -inf and drops out of every merge with
// weight 0, and a row with no live key at all writes zeros).  Sentinel
// entries (>= P) clamp to page P - 1, exactly as the JAX code clamps, and
// stay masked by position.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;     // warps per block
constexpr int U = 4;      // key rows per warp step
constexpr int MAXG = 8;   // query heads per KV head supported

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// EPL consecutive elements of a row as f32 (vector loads where they fit)
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* p, float* out) {
#pragma unroll
  for (int e = 0; e < EPL; ++e) out[e] = to_f32(p[e]);
}
template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 4>(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 2>(const __nv_bfloat16* p, float* out) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  out[0] = a.x; out[1] = a.y;
}
template <>
__device__ __forceinline__ void load_row<float, 4>(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
template <>
__device__ __forceinline__ void load_row<float, 2>(const float* p, float* out) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  out[0] = a.x; out[1] = a.y;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// weight of a partial state with max m against the merged max mx (0 for an
// empty state, m = -inf)
__device__ __forceinline__ float rescale(float m, float mx) {
  return m == -INFINITY ? 0.f : expf(m - mx);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(NW * 32)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ positions,
                          const uint8_t* __restrict__ active, float* __restrict__ part_m,
                          float* __restrict__ part_l, float* __restrict__ part_acc,
                          int B, int KH, int P, int page, int NB, int window,
                          float scale) {
  constexpr int EPL = D >= 32 ? D / 32 : 1;  // elements per lane
  constexpr int LANES = D >= 32 ? 32 : D;     // lanes holding elements
  __shared__ float s_m[NW][G];
  __shared__ float s_l[NW][G];
  __shared__ float s_acc[NW][G][D];
  __shared__ int s_range[2];

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int H = KH * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pos = positions[b];
  const bool lane_on = lane < LANES;

  if (threadIdx.x == 0) {
    // the batch range of the JAX loop: [lo, hi) over active rows
    int max_pos = 0;
    int min_pos = NB * page;
    for (int i = 0; i < B; ++i) {
      if (active == nullptr || active[i] != 0) {
        max_pos = max(max_pos, positions[i]);
        min_pos = min(min_pos, positions[i]);
      }
    }
    int hi = min(max_pos / page + 1, NB);
    int lo = 0;
    if (window > 0) lo = min(max(min_pos - window + 1, 0) / page, hi);
    if (active == nullptr || active[b] != 0) {
      hi = min(hi, min(pos / page + 1, NB));
      if (window > 0) lo = max(lo, max(pos - window + 1, 0) / page);
    }
    // this block's page of the row's range (none once past its end)
    const int c_lo = lo + split;
    s_range[0] = c_lo;
    s_range[1] = min(hi, c_lo + 1);
  }
  __syncthreads();
  const int c_lo = s_range[0];
  const int c_hi = s_range[1];

  float qf[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane_on) {
      load_row<T, EPL>(q + ((size_t)b * H + kh * G + g) * D + lane * EPL, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[g][e] = 0.f;
    }
  }
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const int* bt = block_tables + (size_t)b * NB;
  for (int ci = c_lo; ci < c_hi; ++ci) {
    const int phys = min(max(bt[ci], 0), P - 1);
    const size_t base = ((size_t)phys * KH + kh) * page * D;
    const T* kp = k_pool + base;
    const T* vp = v_pool + base;
    const int first = ci * page;
    for (int t0 = warp * U; t0 < page; t0 += NW * U) {
      if (first + t0 > pos) break;  // rows run in increasing t: the rest are masked
      float kr[U][EPL], vr[U][EPL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (lane_on) {
          load_row<T, EPL>(kp + (size_t)(t0 + u) * D + lane * EPL, kr[u]);
          load_row<T, EPL>(vp + (size_t)(t0 + u) * D + lane * EPL, vr[u]);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) kr[u][e] = vr[u][e] = 0.f;
        }
      }
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kpos = first + t0 + u;
        live[u] = kpos <= pos && (window <= 0 || kpos > pos - window);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float sc[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) part = fmaf(qf[g][e], kr[u][e], part);
          sc[u] = warp_sum(part);
        }
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          sc[u] = live[u] ? sc[u] * scale : -INFINITY;
          mx = fmaxf(mx, sc[u]);
        }
        if (mx == -INFINITY) continue;  // nothing live yet (warp-uniform)
        const float alpha = rescale(m[g], mx);
        float psum = 0.f;
        float p[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[u] = live[u] ? expf(sc[u] - mx) : 0.f;
          psum += p[u];
        }
        l[g] = alpha * l[g] + psum;
        m[g] = mx;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          float a = alpha * acc[g][e];
#pragma unroll
          for (int u = 0; u < U; ++u) a = fmaf(p[u], vr[u][e], a);
          acc[g][e] = a;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
    if (lane_on) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) s_acc[warp][g][lane * EPL + e] = acc[g][e];
    }
  }
  __syncthreads();

  // merge the warps into this split's partial state per query head
  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int g = i / D;
    const int d = i - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, s_m[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = rescale(s_m[w][g], mx);
      num = fmaf(f, s_acc[w][g][d], num);
      den = fmaf(f, s_l[w][g], den);
    }
    const size_t row = ((size_t)b * H + kh * G + g) * n_split + split;
    part_acc[row * D + d] = num;
    if (d == 0) {
      part_m[row] = mx;
      part_l[row] = den;
    }
  }
}

// out[b, h] = merge of the n_split partial states of (b, h), normalised
template <typename T, int D>
__global__ void paged_decode_combine_kernel(const float* __restrict__ part_m,
                                            const float* __restrict__ part_l,
                                            const float* __restrict__ part_acc,
                                            T* __restrict__ out, int n_split) {
  const size_t bh = blockIdx.x;
  const float* pm = part_m + bh * n_split;
  const float* pl = part_l + bh * n_split;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pm[s]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float f = rescale(pm[s], mx);
      num = fmaf(f, part_acc[(bh * n_split + s) * D + d], num);
      den = fmaf(f, pl[s], den);
    }
    store(out + bh * D + d, den > 0.f ? num / den : 0.f);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     const int* bt, const int* pos, const uint8_t* active, float* pm,
                     float* pl, float* pacc, int B, int H, int KH, int P, int page,
                     int NB, int window, cudaStream_t s) {
  const int G = H / KH;
  const int n_split = NB;  // one split per logical page
  const float scale = 1.0f / sqrtf((float)D);
  dim3 grid(B, KH, n_split);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  switch (G) {
#define DABT_CASE(GG)                                                                  \
  case GG:                                                                             \
    paged_decode_split_kernel<T, D, GG><<<grid, NW * 32, 0, s>>>(                      \
        qq, kk, vv, bt, pos, active, pm, pl, pacc, B, KH, P, page, NB, window, scale); \
    break;
    DABT_CASE(1)
    DABT_CASE(2)
    DABT_CASE(4)
    case 8:
      if constexpr (D * 8 <= 1024) {
        paged_decode_split_kernel<T, D, 8><<<grid, NW * 32, 0, s>>>(
            qq, kk, vv, bt, pos, active, pm, pl, pacc, B, KH, P, page, NB, window, scale);
        break;
      } else {
        return cudaErrorInvalidValue;
      }
#undef DABT_CASE
    default:
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<T, D><<<B * H, D >= 32 ? D : 32, 0, s>>>(
      pm, pl, pacc, static_cast<T*>(o), n_split);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  active may be null (every row active).
// part_m, part_l: [B, H, NB] f32 and part_acc: [B, H, NB, D] f32 scratch
// (one split per logical page).  window <= 0 means no sliding window.
// Returns a cudaError_t (0 = success).
extern "C" int dabt_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                 void* out, const void* block_tables,
                                 const void* positions, const void* active,
                                 void* part_m, void* part_l, void* part_acc, int dtype,
                                 int B, int H, int KH, int P, int page, int NB, int D,
                                 int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* pos = static_cast<const int*>(positions);
  const uint8_t* act = static_cast<const uint8_t*>(active);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pacc = static_cast<float*>(part_acc);
  if (KH <= 0 || H % KH != 0 || H / KH > MAXG || page % U != 0 || NB <= 0)
    return (int)cudaErrorInvalidValue;
#define DABT_D(TT, CODE, DD)                                                          \
  if (dtype == CODE && D == DD)                                                       \
    return (int)launch_d<TT, DD>(q, k_pool, v_pool, out, bt, pos, act, pm, pl, pacc, \
                                 B, H, KH, P, page, NB, window, s);
  DABT_D(float, 0, 16)
  DABT_D(float, 0, 32)
  DABT_D(float, 0, 64)
  DABT_D(float, 0, 128)
  DABT_D(float, 0, 256)
  DABT_D(__nv_bfloat16, 1, 16)
  DABT_D(__nv_bfloat16, 1, 32)
  DABT_D(__nv_bfloat16, 1, 64)
  DABT_D(__nv_bfloat16, 1, 128)
  DABT_D(__nv_bfloat16, 1, 256)
#undef DABT_D
  return (int)cudaErrorInvalidValue;
}
